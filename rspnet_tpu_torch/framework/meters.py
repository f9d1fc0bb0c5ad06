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


class MetricSpool:
    """Per-step metric rows kept on the device and read in bulk (port of
    rspnet_tpu/framework/meters.py:84).

    Each step appends one stacked [n_metrics] device tensor; a ``.item()``
    per scalar would wait for the stream at every step. ``last`` reads one
    row (the log interval's line); ``rows`` stacks what is pending and
    reads it in one transfer, at most ``chunk`` rows at a time.
    """

    def __init__(self, chunk: int = 256):
        self.chunk = chunk
        self._pending = []   # (device [n_metrics] row, n)
        self._rows = []      # (list of floats, n), already read

    def append(self, row, n: int = 1) -> None:
        self._pending.append((row, n))
        if len(self._pending) >= self.chunk:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        import torch
        vals = torch.stack([r for r, _ in self._pending]).float().cpu()
        self._rows.extend(zip(vals.tolist(), (n for _, n in self._pending)))
        self._pending = []

    def last(self) -> list:
        """The latest row, as floats (one transfer)."""
        if self._pending:
            return self._pending[-1][0].float().cpu().tolist()
        return self._rows[-1][0]

    def rows(self):
        """Read everything still pending; -> list of (row, n)."""
        self.flush()
        return self._rows
