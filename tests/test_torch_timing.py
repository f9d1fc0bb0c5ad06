"""The port's input-path micro-bench
(rspnet_tpu_torch/utils/bench_input_path.py), on the CPU: it runs both
variants on generated MJPG videos and prints one JSON line (times, shipped
bytes, the decoder that ran).
"""
import json

import pytest


def test_input_path_bench_runs(capsys):
    pytest.importorskip("cv2")       # it writes its videos with OpenCV
    from rspnet_tpu_torch.utils import bench_input_path
    result = bench_input_path.main(["--iters", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    for k in ("host_geometry_ms_per_sample",
              "devgeom_decode_size_ms_per_sample"):
        assert result[k] > 0
    assert result["devgeom_decode_size_bytes_per_sample"] == \
        2 * 24 * 128 * 171 * 3
    assert result["decoder"] in ("native", "opencv")
