"""The port's timing helpers (rspnet_tpu_torch/parallel/mesh.py
``fetch_scalar`` / ``time_enqueued``, the counterparts of
rspnet_tpu/parallel/mesh.py:179-219) and its input-path micro-bench
(rspnet_tpu_torch/utils/bench_input_path.py), on the CPU.

- ``time_enqueued`` keeps the JAX protocol: 3 warm calls and a fourth,
  then ``iters`` calls, the calibration subtracted; its time is positive
  and grows with the work (8x the matmuls take well over 2x the time).
- ``fetch_scalar`` returns a float from a tensor or an array, as the JAX
  one does from a device array.
- The micro-bench runs both variants on generated MJPG videos and prints
  one JSON line (times, shipped bytes, the decoder that ran).
"""
import json

import numpy as np
import pytest
import torch

from rspnet_tpu.parallel.mesh import fetch_scalar as jax_fetch_scalar
from rspnet_tpu_torch.parallel import fetch_scalar, time_enqueued

torch.set_num_threads(1)


def _work(n_matmuls, calls):
    a = torch.randn(192, 192)

    def fn(x):
        calls.append(1)
        for _ in range(n_matmuls):
            x = torch.tanh(x @ a)
        return x.sum()
    return fn


@pytest.mark.parametrize("iters", [1, 6])
def test_protocol_counts_the_calls(iters):
    calls = []
    t = time_enqueued(_work(1, calls), torch.randn(192, 192), iters=iters)
    assert len(calls) == 3 + 1 + iters
    assert t > 0


def test_time_scales_with_the_work():
    x = torch.randn(192, 192)
    small = min(time_enqueued(_work(4, []), x, iters=5) for _ in range(3))
    large = min(time_enqueued(_work(32, []), x, iters=5) for _ in range(3))
    assert large > 2 * small, (small, large)


def test_fetch_scalar_as_jax():
    import jax.numpy as jnp
    v = np.float32(1.25)
    assert fetch_scalar(torch.tensor(v)) == jax_fetch_scalar(jnp.asarray(v))
    assert fetch_scalar(np.asarray(v)) == 1.25
    assert isinstance(fetch_scalar(torch.tensor(3)), float)


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
