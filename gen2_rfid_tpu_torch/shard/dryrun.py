"""The multi-device check of the sharded decode, on a mesh of one device.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (:31-138), with the
JAX package's scenes, seeds and asserted counts.  The mesh is ``n_shards``
positions of one device, split into time and channel as the JAX package
splits its devices.
"""

from __future__ import annotations

import numpy as np
import torch


def _expect(cond, detail) -> None:
    if not cond:
        raise AssertionError(detail)


def dryrun_multichip(n_shards: int, device=None) -> None:
    """Run the sharded decode over ``n_shards`` mesh positions (CUDA unless
    ``device`` says otherwise) on the two scenes that load its risky paths:

    1. a three-tag Q=2 slotted inventory (collisions and empty slots: the
       role-specialized decode and the replay) with per-shard tables sized
       just above the densest shard's load;
    2. a wideband capture split by the filterbank on the device, its two
       occupied channels decoding different inventories on the mesh's
       ``chan`` axis.

    Both assert exact counts; raises AssertionError otherwise."""
    from ..config import ReaderConfig
    from ..dsp.channelizer import channelize_planar
    from ..runtime.inventory import resolve_device, to_planar
    from ..sim.tag import Tag
    from ..sim.trace import synthesize_inventory
    from .decode_sharded import decode_capture_sharded, make_sharded_decoder
    from .mesh import make_mesh

    dev = resolve_device(device)
    n_chan = 2 if n_shards % 2 == 0 else 1
    n_time = n_shards // n_chan
    mesh = make_mesh(n_time=n_time, n_chan=n_chan, devices=[dev] * n_shards)

    # ---- 1. multi-tag Q=2, near-capacity event tables ----
    cfg = ReaderConfig(fixed_q=2, max_events=64)
    tags = [Tag.with_id(11, seed=0, backscatter=0.08),
            Tag.with_id(27, seed=7, backscatter=0.08 * np.exp(1.1j)),
            Tag.with_id(77, seed=3, backscatter=0.08 * np.exp(2.2j))]
    tr = synthesize_inventory(cfg, tags, n_rounds=3, seed=5)
    iq = np.pad(tr.iq, (0, (-len(tr.iq)) % (n_time * cfg.decim)))
    chans = np.stack([iq] * (2 * n_chan))
    # 3 rounds x 4 slots: 12 query-like and 12 ACK events over n_time
    # shards; each table just above the densest shard's load.
    eps = max(8, -(-28 // n_time))
    stats, dec = decode_capture_sharded(chans, cfg, mesh, events_per_shard=eps)
    ok = stats.n_epc_correct.cpu().numpy()
    _expect((ok == tr.expected_epc_pass).all(), (ok, tr.expected_epc_pass))
    reads = stats.tag_reads.cpu().numpy()
    per_tag = {t: int(reads[0, t]) for t in (11, 27, 77)}
    n_ev = int(dec.valid[0].sum())

    # ---- 2. wideband filterbank -> (time, chan) mesh, channel-dependent tags ----
    n_pfb = 4
    wcfg = ReaderConfig(max_events=32)
    synth_cfg = ReaderConfig(adc_rate=wcfg.adc_rate * n_pfb)
    tr_a = synthesize_inventory(synth_cfg, [Tag.with_id(27, seed=7)], n_rounds=2, seed=3,
                                noise=0.0)
    tr_b = synthesize_inventory(synth_cfg, [Tag.with_id(99, seed=9)], n_rounds=2, seed=4,
                                noise=0.0)
    n1 = max(tr_a.iq.size, tr_b.iq.size)

    def place(x, k):
        padc = np.zeros(n1, np.complex64)
        padc[: x.size] = x
        return padc * np.exp(2j * np.pi * k * np.arange(n1) / n_pfb).astype(np.complex64)

    wide = place(tr_a.iq, 1) + place(tr_b.iq, 3)
    m = wide.size // n_pfb
    m_use = m - m % (n_time * wcfg.decim)
    torch.backends.cuda.matmul.allow_tf32 = False
    ch = channelize_planar(to_planar(wide).to(dev), n_pfb)            # (4, 2, M)
    wstats, _ = make_sharded_decoder(wcfg, mesh, events_per_shard=16)(ch[:, :, :m_use])
    wok = wstats.n_epc_correct.cpu().numpy()
    want = np.zeros(n_pfb, np.int64)
    want[1], want[3] = tr_a.expected_epc_pass, tr_b.expected_epc_pass
    wreads = wstats.tag_reads.cpu().numpy()
    _expect((wok == want).all() and int(wreads[1, 27]) == tr_a.expected_epc_pass
            and int(wreads[3, 99]) == tr_b.expected_epc_pass, (wok, want))

    print(
        f"dryrun_multichip({n_shards}): mesh=({n_time} time x {n_chan} chan) of {dev}; "
        f"[1] multi-tag Q=2: {ok[0]}/{tr.expected_epc_pass} EPCs per channel "
        f"x {chans.shape[0]} channels, reads {per_tag}, {n_ev} events over "
        f"{n_time} shards (cap {eps}/shard); "
        f"[2] wideband PFB->mesh: per-channel EPCs {wok.tolist()} "
        f"(tags 0x1b@ch1, 0x63@ch3)"
    )
