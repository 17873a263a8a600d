"""Training event storage, the JSON-lines metrics writer and the optional
TensorBoard writer (the port's copy of ``scenesplat_tpu/utils/events.py``).
Under data parallel only rank 0 writes."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Optional

from scenesplat_tpu_torch.parallel.dist import rank
from scenesplat_tpu_torch.utils.logger import get_root_logger


class HistoryBuffer:
    """(value, iteration) history of one scalar."""

    def __init__(self):
        self._data = []
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: Optional[int] = None):
        self._data.append((value, self._count if iteration is None else iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def values(self):
        return [v for v, _ in self._data]

    def avg(self, window: int = 20) -> float:
        vals = self.values()[-window:]
        return sum(vals) / len(vals)

    def global_avg(self) -> float:
        return self._global_avg


class EventStorage:
    """Scalar histories of a training run, keyed by name, at the current
    iteration."""

    def __init__(self, start_iter: int = 0):
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._iter = start_iter
        self._latest: Dict[str, float] = {}

    def put_scalar(self, name: str, value: float):
        value = float(value)
        self._history[name].update(value, self._iter)
        self._latest[name] = value

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, value):
        self._iter = int(value)

    def step(self):
        self._iter += 1

    @property
    def latest(self) -> Dict[str, float]:
        return self._latest

    def history(self, name: str) -> HistoryBuffer:
        return self._history[name]

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


class JSONWriter:
    """Appends one JSON line of the latest scalars per ``write``; on a rank
    other than 0 it writes nothing."""

    def __init__(self, json_file: str):
        self._file = None
        if rank() == 0:
            os.makedirs(os.path.dirname(os.path.abspath(json_file)), exist_ok=True)
            self._file = open(json_file, "a")

    def write(self, storage: EventStorage):
        if self._file is None:
            return
        record = {"iteration": storage.iter}
        record.update(storage.latest)
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()


_TENSORBOARD_WARNED = []


class TensorboardWriter:
    """Scalars through tensorboardX's ``SummaryWriter`` under ``log_dir``
    when tensorboardX is installed and this is rank 0; otherwise it writes
    nothing, and a process without tensorboardX logs that once."""

    def __init__(self, log_dir: str):
        self._writer = None
        if rank() != 0:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            if not _TENSORBOARD_WARNED:
                _TENSORBOARD_WARNED.append(True)
                get_root_logger().warning("tensorboardX is not installed: no TensorBoard "
                                          f"events under {log_dir}")
            return
        self._writer = SummaryWriter(log_dir)

    def write_scalar(self, name: str, value: float, step: int):
        if self._writer is not None:
            self._writer.add_scalar(name, value, step)

    def write(self, storage: EventStorage):
        if self._writer is None:
            return
        for name, value in storage.latest.items():
            self._writer.add_scalar(name, value, storage.iter)

    def close(self):
        if self._writer is not None:
            self._writer.close()
