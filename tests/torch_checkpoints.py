"""The port's test modules that write checkpoints delete them when the
module ends.

A checkpoint of a full-width model is 100-800 MB, and pytest keeps the
temporary directories of its last three runs. Import ``drop_checkpoints``
into a test module (``from tests.torch_checkpoints import
drop_checkpoints  # noqa: F401``): at the module's end it deletes every
``.pth.tar`` or ``.pth`` file (a checkpoint, or a torch state dict such as
the stand-in for torchvision's r3d_18 weights) that appeared under
pytest's base temporary directory (the worker's own under xdist) while the
module ran. The tests still write and read their checkpoints as before;
only what is left afterwards goes.
"""
import pytest


def _checkpoints(base):
    return {path for pattern in ("*.pth.tar", "*.pth")
            for path in base.rglob(pattern)}


@pytest.fixture(scope="module", autouse=True)
def drop_checkpoints(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before = _checkpoints(base)
    yield
    for path in _checkpoints(base) - before:
        path.unlink(missing_ok=True)
