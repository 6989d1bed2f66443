"""Compat mode at FM0, 8 Msps, decim 1: the padding rows of the paranoid
decode (ROADMAP.md section 3, item 12), on the CPU.

A 32-row table holds the 3-round capture's 6 commands; the other 26 rows
are invalid, and their window is the capture's last 8-sample row repeated,
less the DC.  At 8 Msps a half bit is 100 samples, so the preamble
template's 12 half-bit positions fall on two phases of that 8-sample
pattern, and at every search offset the template's +1 and -1 terms cancel
exactly: the correlation is 0 but for rounding.  Its argmax is decided by
each side's summation order.  The port sums each offset's 12 terms in
order and takes offset 3 (72 offsets tie at 8.7e-19); the JAX package's
batched selection matmul takes offset 14; the card's reductions decode the
rows apart from the CPU's too (chip_smoke.py phase 16b).  From there the rows' h_est, rn16_margin (0.1505 against JAX's 0.2447), t_half
(100.368 against 99.211) and 65 of 128 epc_bits differ, at all 26 rows.
The replay never reads an invalid row: every stats field and every valid
row are equal.  At 16 Msps the whole decodes agree on these rows, but not
by structure: on the port's windows the JAX package's batched sync takes
offset 136 where the port takes 0, over residues of at most 3.5e-18.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gen2_rfid_tpu.dsp import sync as ref_sync
from gen2_rfid_tpu_torch.dsp import gate, sync
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.runtime.frames import extract_windows
from geometry_compare import assert_decode_equals_jax, capture, ref_config
from torch_compare import port_cfg
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_fm0_8msps_compat_decode_equals_jax_but_padding():
    """Every stats field and every valid row equal to the JAX package's;
    the invalid rows' window products are left out (item 12)."""
    assert_decode_equals_jax("fm0_8msps", "compat", invalid_rows=False)


def _frames(name):
    ref_cfg = ref_config(name, "compat")
    cfg = port_cfg(ref_cfg)
    y2, amp, avgsum, _ = gate_front_for_cfg(inv.to_planar(capture(name).iq), cfg)
    y = torch.complex(y2[0], y2[1])
    ev = gate.gate_detect(y, cfg, amp=amp, avg=avgsum / torch.tensor(float(cfg.win_length)))
    frames = extract_windows(y, ev, cfg)[0]
    return ref_cfg, cfg, y, ev, frames


def _jax_power(frames, ref_cfg):
    """The JAX package's preamble power at every offset, batched as its
    ``tag_sync_batch`` computes it."""
    s, _, span = ref_sync._sync_selection(ref_cfg)
    s = jnp.asarray(s)

    def power(frame):
        x = frame[:span]
        hi = ref_sync.SEL_PRECISION
        return (jnp.matmul(jnp.real(x), s, precision=hi) ** 2
                + jnp.matmul(jnp.imag(x), s, precision=hi) ** 2)

    return np.asarray(jax.jit(jax.vmap(power))(jnp.asarray(frames.numpy())))


def test_padding_preamble_correlation_is_zero_but_for_rounding():
    """The premise of item 12, on the port's windows: each padding row is
    the last 8-sample row of y repeated, less the DC; its preamble power is
    under 1e-15 at every offset in both packages' arithmetic, against a
    peak over 1e3 on every valid row; both syncs agree on the valid rows."""
    ref_cfg, cfg, y, ev, frames = _frames("fm0_8msps")
    valid = ev.valid
    assert int(valid.sum()) == 6 and int((~valid).sum()) == 26
    last = y[-8:]
    for row in frames[~valid]:
        assert torch.equal(row, (last.repeat(row.shape[0] // 8) - ev.dc[-1])[:row.shape[0]])
    power, _ = sync.preamble_search(frames, cfg)
    jax_power = _jax_power(frames, ref_cfg)
    for p in (power.numpy().astype(np.float64), jax_power.astype(np.float64)):
        assert (p[~valid.numpy()] < 1e-15).all()
        assert (p[valid.numpy()].max(axis=1) > 1e3).all()
    index, _ = sync.tag_sync(frames, cfg)
    ref_index, _ = jax.jit(jax.vmap(lambda f: ref_sync.tag_sync(f, ref_cfg)))(
        jnp.asarray(frames.numpy()))
    np.testing.assert_array_equal(index.numpy()[valid.numpy()],
                                  np.asarray(ref_index)[valid.numpy()])

