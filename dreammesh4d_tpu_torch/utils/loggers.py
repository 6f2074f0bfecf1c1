"""Metric logger backends: CSV (always), TensorBoard and wandb when
installed (counterpart of ``dreammesh4d_tpu/utils/loggers.py``).  A backend
that cannot be imported warns once and does nothing, as in the JAX package;
``metrics.csv`` records everything.  wandb runs in offline mode.  Under
more than one device only rank 0 logs (the metrics are the global ones)."""

from __future__ import annotations

import csv
import os
import warnings
from typing import Any, Dict, List, Optional

from ..parallel import mesh as _mesh


class CSVLogger:
    """Append-only metrics.csv — the always-on backend."""

    def __init__(self, trial_dir: str, filename: str = "metrics.csv"):
        self.path = os.path.join(trial_dir, filename)
        self._keys: Optional[List[str]] = None

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if self._keys is None:
            self._keys = list(row.keys())
        new_file = not os.path.exists(self.path)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._keys, extrasaction="ignore")
            if new_file:
                w.writeheader()
            w.writerow(row)

    def finalize(self) -> None:
        pass


class TensorBoardLogger:
    """Writes TF event files when a writer implementation is available.

    Tries torch.utils.tensorboard first (its writer needs the tensorboard
    package), then tensorboardX."""

    def __init__(self, trial_dir: str):
        self._writer = None
        logdir = os.path.join(trial_dir, "tb_logs")
        for mod, cls in (("torch.utils.tensorboard", "SummaryWriter"),
                         ("tensorboardX", "SummaryWriter")):
            try:
                import importlib

                writer_cls = getattr(importlib.import_module(mod), cls)
                self._writer = writer_cls(log_dir=logdir)
                break
            except Exception:
                continue
        if self._writer is None:
            warnings.warn(
                "tensorboard not available; tensorboard logging is a no-op "
                "(metrics.csv still records everything)", stacklevel=2)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self._writer is None:
            return
        for k, v in metrics.items():
            self._writer.add_scalar(k, float(v), step)

    def finalize(self) -> None:
        if self._writer is not None:
            self._writer.close()


class WandbLogger:
    """Offline-mode wandb run when the package exists; no-op otherwise."""

    def __init__(self, trial_dir: str, project: str = "dreammesh4d-tpu",
                 name: Optional[str] = None):
        self._run = None
        try:
            os.environ.setdefault("WANDB_MODE", "offline")
            import wandb  # noqa: F401 — optional

            self._run = wandb.init(project=project, name=name,
                                   dir=trial_dir, reinit=True)
        except Exception:
            warnings.warn(
                "wandb not available; wandb logging is a no-op "
                "(metrics.csv still records everything)", stacklevel=2)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self._run is None:
            return
        self._run.log({k: float(v) for k, v in metrics.items()}, step=step)

    def finalize(self) -> None:
        if self._run is not None:
            self._run.finish()


_BACKENDS = {"csv": CSVLogger, "tensorboard": TensorBoardLogger, "wandb": WandbLogger}


def build_loggers(names, trial_dir: str) -> List[Any]:
    """``names``: iterable of backend names (unknown names warn + skip);
    none on a rank other than 0."""
    out: List[Any] = []
    if not _mesh.is_main_process():
        return out
    for n in names:
        cls = _BACKENDS.get(str(n).lower())
        if cls is None:
            warnings.warn(f"unknown logger backend {n!r}; skipping", stacklevel=2)
            continue
        out.append(cls(trial_dir))
    return out


class LoggerCollection:
    """Fans log_metrics out to every backend."""

    def __init__(self, loggers: List[Any]):
        self.loggers = loggers

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def finalize(self) -> None:
        for lg in self.loggers:
            lg.finalize()
