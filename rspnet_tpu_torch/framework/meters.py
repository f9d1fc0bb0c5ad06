"""Running-average meters (port of rspnet_tpu/framework/meters.py;
reference: framework/meters/average.py:4-44). Single process: no sync."""
from __future__ import annotations

from typing import Dict, Iterable


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        if self.count == 0:
            return 0.0
        return self.sum / self.count

    def __str__(self) -> str:
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class MeterGroup:
    """Convenience bundle used by the engines for log lines."""

    def __init__(self, names: Iterable[str], fmt: str = ":.4f"):
        self.meters: Dict[str, AverageMeter] = {
            n: AverageMeter(n, fmt) for n in names}

    def __getitem__(self, name: str) -> AverageMeter:
        return self.meters[name]

    def update(self, values: Dict[str, float], n: int = 1) -> None:
        for k, v in values.items():
            self.meters[k].update(v, n)

    def reset(self) -> None:
        for m in self.meters.values():
            m.reset()

    def __str__(self) -> str:
        return "\t".join(str(m) for m in self.meters.values())
