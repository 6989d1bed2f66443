"""The benchmark's plain reference decode.

Plain PyTorch and NumPy, frozen under the benchmark and written from what
each output means, not from how the port computes it: what the port's
timed entry ``decode_capture_planar`` must return for a native-mode
capture, FM0 or Miller-M, without CW cancellation, channel tracking or
soft EPC recovery.

* ``front``: the boxcar matched filter summed in float64; the gate's
  threshold (a fraction of the mean |y| over the last ``win`` samples); its
  state machine walked over the capture a run of equal samples at a time
  on the host, counting PIE pulses between resets; each event's DC and
  noise.
* ``detect``: each reply window's preamble sync, FM0 slicer and period
  search, and Miller segment cascade, over the decoder's own grids and
  positions, every sum in float64.
* ``decode``: the command type of each event from its pulse count, every
  event decoded on its own as the window its command opens, the EPC's
  CRC-16 stepped bit by bit, the slot verdict by the configuration's
  ``slot_rule`` (``decode.SlotRule``; FM0's where it gives none), and the
  round replay walked event by event.

It imports nothing of the port: ``decode.decode_capture(x2, cfg)`` takes the
same planar capture the program is given and a configuration from
``rfidbench.synth``.  ``front_dtype=torch.bfloat16`` computes the front end
(the capture and the tap sums) in bfloat16, the next precision below the
float32 the configurations state: the control the comparison has to
reject.  The synthesizer's ground truth, the second witness, is held in
``rfidbench/judge.py``.
"""
