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
and is used only when asked for.  The JAX launcher's ``--gpu``,
``--verbose`` and ``--typecheck`` are accepted and kept out of the dotlist:
the first two change nothing, ``--typecheck`` logs that the port has no
shape annotations to check.  A trial is written as the JAX launcher
writes it: ``<exp_root_dir>/<name>/<tag>/`` with ``configs/parsed.yaml``,
``cmd.txt``, ``code_snapshot.txt`` (best effort), ``metrics.csv``,
``ckpts/step_XXXXXXXX/`` and ``save/``.

More than one device, as the JAX launcher's YAML surface has it::

    python3 -m dreammesh4d_tpu_torch.launch --config ... --train trainer.devices=4 trainer.mesh=[2,2]

spawns one process per rank (``torch.multiprocessing``, ``spawn``), which
meet at a free local port and run the verb on the ``(data, model)`` grid
(``parallel/``): NCCL with one card per rank, ``gloo`` on the CPU.  The
errors of a bad mesh, an indivisible batch or too few devices are raised
here, before any process starts; a rank that fails fails the run with its
traceback.  Rank 0 writes the trial; the timestamp is off, as in the
reference with more than one GPU.  The zoo's systems
(``systems/assembly_zoo.py``) run in one process only, as in the JAX
package: ``trainer.devices > 1`` on them raises.
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
import torch.distributed as dist
import torch.multiprocessing as mp

from .config import dump_config, load_config
from .parallel import mesh as pmesh
from .parallel.context import plan_from_trainer_cfg
from .systems.assembly import build_experiment, check_parallel_batch
from .systems.assembly_zoo import ZOO_EXPERIMENTS
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
    (``train`` / ``validate`` / ``test`` / ``export``), and may have
    ``typecheck``; ``extras`` is the dotlist.  Returns nothing; the trial
    directory holds the results."""
    logging.basicConfig(level=logging.INFO)
    if getattr(args, "typecheck", False):
        logging.getLogger(__name__).info(
            "--typecheck: the port has no shape annotations; nothing is checked at run time")
    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the launcher runs on the card; pass --device cpu to "
                           "run the plain PyTorch versions on the CPU")
    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg = load_config(args.config, cli_args=extras, n_gpus=world, makedirs=False)
    plan = plan_from_trainer_cfg(cfg.trainer, device)
    if plan is not None and cfg.system_type in ZOO_EXPERIMENTS:
        raise RuntimeError(f"trainer.devices={plan[0]}: {cfg.system_type} runs in one process; more "
                           "than one device for the zoo's systems is not ported yet (ROADMAP A8)")
    if world == 1 and plan is not None:
        check_parallel_batch(cfg, plan[1])
        spawn(_run_verb, plan[0], device, args=(_plain_args(args), list(extras)))
        return
    if world > 1:
        if plan is None or plan[0] != world:
            raise RuntimeError(f"trainer.devices={plan[0] if plan else 1} inside a process group of "
                               f"{world} ranks")
        device = pmesh.rank_device(device, dist.get_rank())
    if pmesh.is_main_process():
        os.makedirs(cfg.trial_dir, exist_ok=True)
        _snapshot(cfg)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)

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


def _plain_args(args) -> SimpleNamespace:
    """What :func:`main` reads of ``args``, picklable for the ranks."""
    return SimpleNamespace(config=args.config, device=str(getattr(args, "device", "cuda")),
                           **{v: bool(getattr(args, v, False)) for v in VERBS})


def _run_verb(rank: int, args, extras) -> None:
    main(args, extras)


def _rank_entry(rank: int, world: int, port: int, device: str, backend, threads: int, fn,
                fn_args) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    pmesh.init_process_group(world, rank, device, port, backend=backend)
    try:
        fn(rank, *fn_args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, device="cuda", backend=None, args=()) -> None:
    """``fn(rank, *args)`` in ``world`` spawned processes, each inside the
    ``world``-rank process group (``parallel.mesh.init_process_group``:
    ``backend`` NCCL on cards, ``gloo`` on the CPU by default), on a free
    local port; ``fn`` must be importable (a module-level function).  CPU
    ranks share this process's torch threads.  A rank that raises ends
    every rank and raises here with its traceback."""
    threads = max(1, torch.get_num_threads() // world)
    mp.start_processes(_rank_entry, args=(world, pmesh.free_port(), str(device), backend, threads, fn,
                                          tuple(args)),
                       nprocs=world, join=True, start_method="spawn")


def make_args(config: str, verb: str = "train", device: str = "cuda") -> SimpleNamespace:
    """The ``args`` of :func:`main` for a call from code."""
    if verb not in VERBS:
        raise ValueError(f"verb must be one of {VERBS}, not {verb!r}")
    return SimpleNamespace(config=config, device=device, **{v: v == verb for v in VERBS})


def parse_args(argv=None):
    """``(args, dotlist)``.  ``--gpu``, ``--verbose`` and ``--typecheck`` are
    the JAX launcher's flags (``launch.py:162,168-170``): accepted and kept
    out of the dotlist; ``--device`` takes the place of ``--platform``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="path to config file")
    parser.add_argument("--gpu", default="0", help="accepted for compatibility; --device places the run")
    group = parser.add_mutually_exclusive_group(required=True)
    for verb in VERBS:
        group.add_argument(f"--{verb}", action="store_true")
    parser.add_argument("--verbose", action="store_true", help="accepted for compatibility; no effect")
    parser.add_argument("--typecheck", action="store_true",
                        help="accepted for compatibility; the port has no shape annotations to check")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain PyTorch versions)")
    return parser.parse_known_args(argv)


if __name__ == "__main__":
    main(*parse_args())
