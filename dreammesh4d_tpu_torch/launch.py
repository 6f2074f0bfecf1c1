"""Launcher of the PyTorch port (counterpart of the repository's
``launch.py``), with the same verbs and dotlist overrides:

    python3 -m dreammesh4d_tpu_torch.launch --config configs/sugar_static_refine.yaml --train \\
        system.guidance.pretrained_model_name_or_path=none data.image_path=<rgba png> \\
        system.geometry.surface_mesh_to_bind_path=<mesh>
    python3 -m dreammesh4d_tpu_torch.launch --config configs/sugar_dynamic_dg.yaml --train \\
        system.guidance.pretrained_model_name_or_path=none data.video_frames_dir=<frames> \\
        system.geometry.surface_mesh_to_bind_path=<mesh> system.weights=<static trial>/ckpts/step_XXXXXXXX
    python3 -m dreammesh4d_tpu_torch.launch --config ... --test resume=LAST

``--train`` fits, then runs the test pass; ``--validate`` / ``--test`` /
``--export`` restore ``resume=`` first.  ``--device`` (default ``cuda``)
places everything; ``cpu`` runs the plain PyTorch versions of the kernels
and is used only when asked for.  A trial is written as the JAX launcher
writes it: ``<exp_root_dir>/<name>/<tag>/`` with ``configs/parsed.yaml``,
``cmd.txt``, ``code_snapshot.txt`` (best effort), ``metrics.csv``,
``ckpts/step_XXXXXXXX/`` and ``save/``.
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .config import dump_config, load_config
from .systems.assembly import build_experiment
from .trainer import Trainer, TrainerConfig
from .utils.checkpoint import find_last_path, latest_checkpoint, restore_checkpoint

VERBS = ("train", "validate", "test", "export")


def _snapshot(cfg) -> None:
    """``configs/parsed.yaml``, ``cmd.txt`` and a best-effort ``code_snapshot.txt``."""
    os.makedirs(os.path.join(cfg.trial_dir, "configs"), exist_ok=True)
    dump_config(os.path.join(cfg.trial_dir, "configs", "parsed.yaml"), cfg)
    with open(os.path.join(cfg.trial_dir, "cmd.txt"), "w") as f:
        f.write(" ".join(sys.argv) + "\n")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             timeout=10, cwd=here)
        diff = subprocess.run(["git", "diff", "HEAD"], capture_output=True, text=True, timeout=30,
                              cwd=here)
    except (OSError, subprocess.SubprocessError):
        return
    with open(os.path.join(cfg.trial_dir, "code_snapshot.txt"), "w") as f:
        f.write(f"commit: {rev.stdout.strip()}\n\n{diff.stdout}")


def trainer_config(cfg) -> TrainerConfig:
    t = dict(cfg.trainer or {})
    max_steps = int(t.get("max_steps", 2000))
    return TrainerConfig(
        max_steps=max_steps,
        log_every_n_steps=int(t.get("log_every_n_steps", 10)),
        val_check_interval=int(t.get("val_check_interval", 200)),
        checkpoint_every=int(dict(cfg.checkpoint or {}).get("every_n_train_steps", max_steps)),
        loggers=tuple(t.get("loggers", ("csv",))),
        profile_start_step=int(t.get("profile_start_step", -1)),
        profile_steps=int(t.get("profile_steps", 5)),
    )


def _maybe_resume(experiment, cfg) -> None:
    if not cfg.resume:
        return
    resume = str(cfg.resume)
    if resume == "LAST":
        path = latest_checkpoint(os.path.join(cfg.trial_dir, "ckpts"))
        if path is None:
            raise FileNotFoundError(f"No checkpoints in {cfg.trial_dir}/ckpts")
    else:
        path = find_last_path(resume)
    experiment.load_state(restore_checkpoint(path, experiment.device))
    print(f"[INFO] restored {path}")


def main(args, extras) -> None:
    """Run one verb.  ``args`` has ``config``, ``device`` and the verb flags
    (``train`` / ``validate`` / ``test`` / ``export``); ``extras`` is the
    dotlist.  Returns nothing; the trial directory holds the results."""
    logging.basicConfig(level=logging.INFO)
    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the launcher runs on the card; pass --device cpu to "
                           "run the plain PyTorch versions on the CPU")
    cfg = load_config(args.config, cli_args=extras)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    _snapshot(cfg)

    experiment = build_experiment(cfg, device=device)
    trainer = Trainer(trainer_config(cfg), cfg.trial_dir)
    if args.train:
        trainer.fit(experiment, resume=cfg.resume)
        trainer.test(experiment)
    elif args.validate:
        _maybe_resume(experiment, cfg)
        trainer.validate(experiment)
    elif args.test:
        _maybe_resume(experiment, cfg)
        trainer.test(experiment)
    elif args.export:
        _maybe_resume(experiment, cfg)
        trainer.predict(experiment)
    else:
        raise ValueError("Specify one of --train / --validate / --test / --export")


def make_args(config: str, verb: str = "train", device: str = "cuda") -> SimpleNamespace:
    """The ``args`` of :func:`main` for a call from code."""
    if verb not in VERBS:
        raise ValueError(f"verb must be one of {VERBS}, not {verb!r}")
    return SimpleNamespace(config=config, device=device, **{v: v == verb for v in VERBS})


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="path to config file")
    group = parser.add_mutually_exclusive_group(required=True)
    for verb in VERBS:
        group.add_argument(f"--{verb}", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain PyTorch versions)")
    return parser.parse_known_args(argv)


if __name__ == "__main__":
    main(*parse_args())
