"""Each case of ``tools/bench_configs.py``'s ``main`` on the CPU, narrowed to
2 rounds, one tile and one timed decode: one JSON line with the JAX
script's keys and the twin's added ones, ``"device": "cpu"`` and no kernel
launches.  A Miller decode on the CPU takes 3-8 s at these tables' sizes
whatever the capture's length, so this file stands apart from
``test_torch_bench.py``.
"""

import pytest

from bench_compare import ADDED_KEYS, JAX_KEYS, NO_LAUNCHES, check_line, run_main
from gen2_rfid_tpu_torch.tools import bench_configs
from gen2_rfid_tpu_torch.tools.bench_configs import CASES, DecodeCase
from sweep_compare import keep_tf32_flags  # noqa: F401
from torch_compare import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", list(CASES))
def test_bench_configs_main_on_cpu(capsys, name):
    rc, lines, _ = run_main(bench_configs, ["--configs", name, "--rounds", "2", "--tiles", "1",
                                            "--decodes", "1"], capsys)
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    assert line["metric"] == f"iq_decode_throughput[{name}]"
    single = isinstance(CASES[name], DecodeCase)
    check_line(line, JAX_KEYS | ADDED_KEYS | ({"roles"} if single else {"epcs_by_channel"}),
               decodes=1)
    assert line["launches"] == NO_LAUNCHES
    assert line["value"] == pytest.approx(line["samples_per_iter"] / line["decode_ms"] / 1e3)
    if name == "wideband8":
        assert line["epcs_by_channel"] == [0, 2, 0, 0, 0, 0, 2, 0] and line["epcs"] == 4
    else:
        assert line["roles"]["ack_rows"] > 0 and not line["roles"]["fallback"]
