"""augment.device_ms: the median over the window's steps of the device
time of the step's two `rsp.augment` phases (the q and k clips: the copy
of a host clip, `crop_resize` and K3), from the program's CUDA events."""
from benchmark import spans


def read(ctx):
    return spans.phases_device_ms(ctx, ["rsp.augment"])
