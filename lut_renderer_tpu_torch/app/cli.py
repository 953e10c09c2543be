"""lut-torch: the port's CLI.

  render    queue files through the PyTorch/CUDA pipeline (fast or pro mode)
  doctor    environment health check: torch, CUDA, nvcc, the card, hostio

The parser, the parameter flags, task creation and the queue loop are the
JAX package's own (lut_renderer_tpu.app.cli), which import no jax; the
port plugs in its TaskManager and adds ``--device`` (default ``cuda``; a
missing card is an error, never a CPU fallback).

    python -m lut_renderer_tpu_torch.app.cli render clip.mp4 --lut look.cube
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from lut_renderer_tpu.app import cli as base_cli
from lut_renderer_tpu.app import load_settings, remember_lut, save_settings
from lut_renderer_tpu.app.taskfactory import create_tasks

from ..device import resolve_device

COMMANDS = ("render", "doctor")


def cmd_render(args) -> int:
    from ..tasks import TaskManager

    device = resolve_device(args.device)
    params = base_cli._params_from_args(args)
    lut = Path(args.lut) if args.lut else None
    if lut and not lut.exists():
        print(f"error: LUT not found: {lut}", file=sys.stderr)
        return 2
    master_dir = args.master_dir
    if params.processing_mode == "pro":
        settings = load_settings()
        if not master_dir:
            master_dir = settings.get("intermediate_dir") or None
            if master_dir:
                print(f"using remembered master dir: {master_dir}")
        elif settings.get("intermediate_dir") != master_dir:
            settings["intermediate_dir"] = master_dir
            save_settings(settings)
    try:
        batch = create_tasks(
            [Path(p) for p in args.files],
            params,
            lut_path=lut,
            out_dir=Path(args.out_dir) if args.out_dir else None,
            master_dir=Path(master_dir) if master_dir else None,
        )
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    for line in batch.logs:
        print(line)
    for warning in batch.warnings:
        print(f"warning: {warning}", file=sys.stderr)
    if not batch.tasks:
        return 2
    if args.dry_run:
        return base_cli._print_plans(batch.tasks)
    if lut:
        remember_lut(lut)

    manager = TaskManager(max_concurrency=args.concurrency,
                          lut_strategy=args.lut_strategy,
                          profile_dir=args.profile, device=device)
    for task in batch.tasks:
        manager.add_task(task)
    return base_cli._run_queue(manager, args)


def _nvidia_smi() -> str:
    exe = shutil.which("nvidia-smi")
    if not exe:
        raise RuntimeError("nvidia-smi not on PATH")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip()


def cmd_doctor(args) -> int:
    """Environment health check of the port: what the render path needs
    on this machine."""
    ok = True

    def report(name, good, detail=""):
        nonlocal ok
        print(f"  {name:<28} {'ok' if good else 'MISSING'}  {detail}")
        ok = ok and good

    print("compute:")
    report("torch", True, f"{torch.__version__} (CUDA build "
                          f"{torch.version.cuda or 'none'})")
    cuda = torch.cuda.is_available()
    report("CUDA device", cuda,
           f"{torch.cuda.device_count()}x {torch.cuda.get_device_name(0)}"
           if cuda else "torch sees no CUDA device")
    if cuda:
        try:
            report("card name, power limit", True, _nvidia_smi())
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            report("card name, power limit", False, str(exc)[:80])
    from ..ops import _build

    try:
        nvcc = _build.nvcc_path()
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        report("nvcc (kernel build)", True,
               f"{nvcc}: {ver.splitlines()[-1] if ver else '?'}")
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        report("nvcc (kernel build)", False, str(exc)[:80])
    print(f"  kernels build into {_build.BUILD_DIR}")

    print("media layer:")
    try:
        from lut_renderer_tpu.hostio.ffi import get_ffi

        get_ffi()
        report("hostio FFmpeg libs", True, "layout verified")
    except Exception as exc:  # a probe: any failure means it cannot load
        report("hostio FFmpeg libs", False, str(exc)[:80])
    print("overall:", "ok" if ok else "problems found")
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's parser cut to the commands the port runs, with
    the port's handlers and ``--device``."""
    parser = base_cli.build_parser()
    parser.prog = "lut-torch"
    parser.description = "PyTorch/CUDA batch video 3D-LUT processor"
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    for name in list(sub.choices):
        if name not in COMMANDS:
            del sub.choices[name]
    sub._choices_actions = [a for a in sub._choices_actions
                            if a.dest in COMMANDS]
    render = sub.choices["render"]
    render.add_argument("--device", default="cuda",
                        help="cuda, cuda:N, or cpu (default cuda)")
    render.set_defaults(fn=cmd_render)
    sub.choices["doctor"].set_defaults(fn=cmd_doctor)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout consumer closed early: point fd 1 at devnull so the
        # interpreter-exit flush stays silent
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, 1)
        return 0


if __name__ == "__main__":
    sys.exit(main())
