"""Polyphase filterbank channelizer: wideband capture -> per-reader channels.

PyTorch counterpart of ``gen2_rfid_tpu/dsp/channelizer.py``.  Channel k of an
N-channel split is the mix-down by k/N of the input rate, the prototype
lowpass and decimation by N, computed as

    y_k[m] = sum_q u_q[m] e^{+j 2 pi k (N-1-q) / N}
    u_q[m] = sum_{r<T} h[rN + N-1-q] s[m - r, q],   s[m, q] = x[mN + q - (N-1)]

with zero history: the commutator ``s`` is one front pad and a reshape, the
T-tap branch filters are T shifted multiply-adds on (2, M, N) in tap order,
and the N-point IDFT over branches is one (M, N) x (N, N) matmul on each
plane, its twiddles in the JAX package's column order.  (The JAX package
runs the branch filters as a blocked selection matmul, whose dense table
grows as N^2; the sums are the same.)  Channel k sits at k * rate / N, FFT
order (k >= N/2 are negative offsets).
"""

from __future__ import annotations

import numpy as np
import torch


def pfb_taps(n_chan: int, taps_per_branch: int = 12) -> np.ndarray:
    """Hamming-windowed-sinc prototype lowpass of length n_chan *
    taps_per_branch, cutoff half the channel spacing, unity DC gain
    (channelizer.py:71-84)."""
    length = n_chan * taps_per_branch
    t = np.arange(length, dtype=np.float64) - (length - 1) / 2.0
    h = np.sinc(t / n_chan) / n_chan
    h *= np.hamming(length)
    h /= h.sum()
    return h.astype(np.float32)


def _check_tf32(x: torch.Tensor) -> None:
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("channelize_planar needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def channelize_planar(iq2: torch.Tensor, n_chan: int, taps_per_branch: int = 12
                      ) -> torch.Tensor:
    """Split a planar (2, N) float32 wideband capture into (n_chan, 2,
    N // n_chan) float32 channels, on iq2's device (channelizer.py:87-160)."""
    _check_tf32(iq2)
    dev = iq2.device
    x = iq2.to(torch.float32)
    m = x.shape[1] // n_chan
    t = taps_per_branch
    h = pfb_taps(n_chan, t)
    # hpq[q, r] = h[r*N + N-1-q]: branch N-1-q, the unreversed commutator
    # column order.
    hpq = torch.as_tensor(np.ascontiguousarray(h.reshape(t, n_chan).T[::-1, :]), device=dev)
    xe = torch.cat([x.new_zeros((2, n_chan - 1)), x[:, : m * n_chan - (n_chan - 1)]], dim=1)
    # s[m', q] for m' = -(T-1) .. M-1, the first T-1 rows zero history.
    s = torch.cat([x.new_zeros((2, t - 1, n_chan)), xe.reshape(2, m, n_chan)], dim=1)
    u = hpq[:, 0] * s[:, t - 1:]
    for r in range(1, t):
        u = u + hpq[:, r] * s[:, t - 1 - r: t - 1 - r + m]
    k_idx = np.arange(n_chan)
    wq = np.exp(2j * np.pi * np.outer(k_idx, k_idx) / n_chan)[:, ::-1].T     # (q, k)
    wr = torch.as_tensor(np.ascontiguousarray(wq.real).astype(np.float32), device=dev)
    wi = torch.as_tensor(np.ascontiguousarray(wq.imag).astype(np.float32), device=dev)
    ur, ui = u[0], u[1]
    yr = torch.matmul(ur, wr) - torch.matmul(ui, wi)
    yi = torch.matmul(ur, wi) + torch.matmul(ui, wr)
    return torch.stack([yr, yi]).permute(2, 0, 1).contiguous()


def channelize(iq, n_chan: int, taps_per_branch: int = 12, device=None) -> np.ndarray:
    """Host convenience: complex wideband capture -> (n_chan, M) complex64,
    channelized on CUDA unless ``device`` says otherwise.  An entry point: it
    turns TF32 matmuls off, which ``channelize_planar`` checks."""
    from ..runtime.inventory import resolve_device, to_planar

    torch.backends.cuda.matmul.allow_tf32 = False
    out = channelize_planar(to_planar(iq).to(resolve_device(device)), n_chan,
                            taps_per_branch).cpu().numpy()
    return (out[:, 0] + 1j * out[:, 1]).astype(np.complex64)


def channel_frequency(k: int, n_chan: int, input_rate: float) -> float:
    """Center frequency offset of PFB channel k (FFT order: k >= N/2 are
    negative)."""
    kk = k if k < n_chan / 2 else k - n_chan
    return kk * input_rate / n_chan


def decode_wideband_planar(iq2: torch.Tensor, n_chan: int, cfg, taps_per_branch: int = 12):
    """Channelize a planar (2, N) wideband capture on its device and decode
    each channel there: a list of (InventoryStats, DecodedEvents), one per
    PFB channel.  Each channel's rate, input_rate / n_chan, must be
    ``cfg.adc_rate``."""
    from ..runtime.inventory import decode_capture_planar

    chans = channelize_planar(iq2, n_chan, taps_per_branch)
    return [decode_capture_planar(chans[k], cfg, device=iq2.device) for k in range(n_chan)]


def decode_wideband(iq, n_chan: int, cfg, taps_per_branch: int = 12, device=None):
    """Host convenience of ``decode_wideband_planar`` (channelizer.py:218-230):
    a complex wideband capture in, decoded on CUDA unless ``device`` says
    otherwise, with no host round trip between the channelizer and the
    decodes.  An entry point: it turns TF32 matmuls off."""
    from ..runtime.inventory import resolve_device, to_planar

    torch.backends.cuda.matmul.allow_tf32 = False
    return decode_wideband_planar(to_planar(iq).to(resolve_device(device)), n_chan, cfg,
                                  taps_per_branch)


def decode_wideband_sharded(iq, n_chan: int, cfg, mesh, events_per_shard: int = 256,
                            taps_per_branch: int = 12):
    """Channelize a wideband capture and decode every channel on a (time,
    chan) mesh (channelizer.py:180-215): the filterbank on the mesh's first
    device, the channels cut to a multiple of n_time * decim samples, then
    the sharded decode (shard/decode_sharded.py), channels on the ``chan``
    axis and time blocks on the ``time`` axis.  Returns (per-channel
    InventoryStats stacked on the channel axis, the joined DecodedEvents).
    An entry point: it turns TF32 matmuls off."""
    from ..runtime.inventory import to_planar
    from ..shard.decode_sharded import make_sharded_decoder
    from ..shard.mesh import TIME_AXIS

    torch.backends.cuda.matmul.allow_tf32 = False
    iq2 = to_planar(iq).to(mesh.devices[0, 0])
    n_time = mesh.shape[TIME_AXIS]
    m = iq2.shape[1] // n_chan
    m_use = m - m % (n_time * cfg.decim)
    ch = channelize_planar(iq2, n_chan, taps_per_branch)
    return make_sharded_decoder(cfg, mesh, events_per_shard)(ch[:, :, :m_use])
