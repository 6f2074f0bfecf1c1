"""Training loop (counterpart of ``dreammesh4d_tpu/trainer.py``): a host loop
around an experiment's train step with metrics logging (CSV + stdout), a
``progress`` file, periodic validation, checkpoints and resume.

An experiment provides:

    experiment.state                      # the train state (its .step counts updates)
    experiment.train_step(step) -> metrics (dict of 0-d tensors)
    experiment.validate(step, test=False) # render + save artifacts
    experiment.export()                   # predict / export
    experiment.state_for_checkpoint() -> dict;  experiment.load_state(dict)

Resuming restores the saved state, and the loop continues from the step in
the checkpoint's name.  The experiment's random generator is not part of the
state: after a resume it starts again from its seed, as the JAX trainer's
key does.

Under more than one device every rank runs the loop and restores
``resume``; rank 0 alone logs, prints, writes the progress file,
checkpoints, validates, tests and exports, and the others wait for it at a
barrier.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from .parallel import mesh as pmesh
from .utils.checkpoint import (find_last_path, latest_checkpoint, restore_checkpoint,
                               save_checkpoint, step_from_path)

log = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    max_steps: int = 2000
    log_every_n_steps: int = 10
    val_check_interval: int = 200
    checkpoint_every: int = 2000
    # a torch.profiler trace into <trial>/profile over
    # [profile_start_step, profile_start_step + profile_steps)
    profile_start_step: int = -1
    profile_steps: int = 5
    # logger backends; unavailable ones warn and do nothing
    loggers: tuple = ("csv",)


class Trainer:
    def __init__(self, cfg: TrainerConfig, trial_dir: str):
        self.cfg = cfg
        self.trial_dir = trial_dir
        self.ckpt_dir = os.path.join(trial_dir, "ckpts")
        self.is_main = pmesh.is_main_process()
        if self.is_main:
            os.makedirs(trial_dir, exist_ok=True)
        from .utils.loggers import LoggerCollection, build_loggers

        self.logger = LoggerCollection(build_loggers(cfg.loggers, trial_dir))

    def fit(self, experiment, resume: Optional[str] = None) -> None:
        """Steps from the resumed step (or 0) to ``max_steps``.  ``resume``:
        ``"LAST"`` (the trial's newest checkpoint, if any), a step directory,
        or ``<dir>/LAST``; the loop continues from the resolved directory's
        step (the JAX trainer reads the step from the unresolved path, and
        restarts ``<dir>/LAST`` at 0)."""
        start_step = 0
        if resume:
            path = latest_checkpoint(self.ckpt_dir) if resume == "LAST" else find_last_path(resume)
            if path:
                experiment.load_state(restore_checkpoint(path, experiment.device))
                start_step = step_from_path(path)
                log.info("Resumed from %s (step %d)", path, start_step)

        cfg = self.cfg
        profiler = None
        t0 = window = time.time()
        for step in range(start_step, cfg.max_steps):
            if self.is_main and step == cfg.profile_start_step:
                profiler = _start_profiler(experiment.device)
            metrics = experiment.train_step(step)
            if profiler is not None and step == cfg.profile_start_step + cfg.profile_steps - 1:
                _stop_profiler(profiler, os.path.join(self.trial_dir, "profile"))
                profiler = None
            if self.is_main and (step % cfg.log_every_n_steps == 0 or step == cfg.max_steps - 1):
                self.logger.log_metrics(metrics, step)
                dt = time.time() - window
                window = time.time()
                loss = float(metrics.get("loss_total", 0.0))
                print(f"[step {step}/{cfg.max_steps}] loss={loss:.4f} "
                      f"({dt / max(cfg.log_every_n_steps, 1):.3f}s/it)", flush=True)
                with open(os.path.join(self.trial_dir, "progress"), "w") as pf:
                    pf.write(f"{step}/{cfg.max_steps} loss={loss:.4f}")
            if cfg.val_check_interval > 0 and (step + 1) % cfg.val_check_interval == 0:
                self._on_main(experiment.validate, step + 1)
            if (step + 1) % cfg.checkpoint_every == 0 or step == cfg.max_steps - 1:
                save_checkpoint(self.ckpt_dir, step + 1, experiment.state_for_checkpoint())
        if profiler is not None:
            _stop_profiler(profiler, os.path.join(self.trial_dir, "profile"))
        total = time.time() - t0
        self.logger.finalize()
        if self.is_main:
            with open(os.path.join(self.trial_dir, "train_summary.json"), "w") as f:
                json.dump({"steps": cfg.max_steps, "wall_s": total}, f)
            print(f"Training finished in {total:.1f}s", flush=True)

    def _on_main(self, fn, *args, **kwargs) -> None:
        """``fn`` on rank 0; every rank then waits for it."""
        if self.is_main:
            fn(*args, **kwargs)
        pmesh.barrier()

    def validate(self, experiment) -> None:
        self._on_main(experiment.validate, experiment.state.step)

    def test(self, experiment) -> None:
        self._on_main(experiment.validate, self.cfg.max_steps, test=True)

    def predict(self, experiment) -> None:
        self._on_main(experiment.export)


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, out_dir: str) -> None:
    profiler.stop()
    os.makedirs(out_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    log.info("Profiler trace saved to %s", out_dir)
