"""lut-torch: the port's CLI.

  render    queue files through the PyTorch/CUDA pipeline (fast or pro mode)
  doctor    environment health check: torch, CUDA, nvcc, the card, hostio

``_add_param_flags``, ``_params_from_args``, ``_print_plans`` and
``_run_queue`` are copies of lut_renderer_tpu/app/cli.py's, kept verbatim
(tests/test_torch_hostside.py holds the render flags to the JAX parser's).
The port adds ``--device`` (default ``cuda``; a missing card is an error,
never a CPU fallback).

    python -m lut_renderer_tpu_torch.app.cli render clip.mp4 --lut look.cube
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..device import resolve_device
from ..models import ProcessingParams
from . import presets as presets_mod
from .defaults import mode_template
from .lut_history import remember_lut
from .settings import load_settings, save_settings
from .taskfactory import create_tasks


def _add_param_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mode", choices=["fast", "pro"], default="fast",
                   help="fast delivery or two-stage pro mastering")
    p.add_argument("--preset-name", help="load a saved preset as the base")
    p.add_argument("--codec", dest="video_codec")
    p.add_argument("--audio-codec", dest="audio_codec")
    p.add_argument("--pix-fmt", dest="pix_fmt")
    p.add_argument("--resolution")
    p.add_argument("--bitrate")
    p.add_argument("--fps")
    p.add_argument("--crf")
    p.add_argument("--enc-preset", dest="preset")
    p.add_argument("--tune")
    p.add_argument("--gop")
    p.add_argument("--enc-profile", dest="profile")
    p.add_argument("--level")
    p.add_argument("--threads")
    p.add_argument("--audio-bitrate", dest="audio_bitrate")
    p.add_argument("--sample-rate", dest="sample_rate")
    p.add_argument("--channels")
    p.add_argument("--faststart", action="store_true", default=None)
    p.add_argument("--cover", action="store_true", default=None,
                   help="extract a cover JPEG next to the output")
    p.add_argument("--bit-depth", dest="bit_depth_policy",
                   choices=["preserve", "auto", "force_8bit"])
    p.add_argument("--no-force-cfr", action="store_true",
                   help="don't force CFR for VFR sources")
    p.add_argument("--no-inherit-metadata", action="store_true")
    p.add_argument("--interp",
                   choices=["nearest", "trilinear", "tetrahedral",
                            "pyramid", "prism", "cubic"])
    p.add_argument("--dither", dest="zscale_dither",
                   choices=["none", "error_diffusion", "ordered", "random"])
    p.add_argument("--input-matrix", dest="lut_input_matrix")
    p.add_argument("--output-tags", dest="lut_output_tags",
                   choices=["bt709", "inherit", "none"])


def _params_from_args(args) -> ProcessingParams:
    if args.preset_name:
        base = presets_mod.load_preset(args.preset_name)
        base.processing_mode = args.mode
    else:
        base = mode_template(args.mode)
    mapping = {
        "video_codec": args.video_codec,
        "audio_codec": args.audio_codec,
        "pix_fmt": args.pix_fmt,
        "resolution": args.resolution,
        "bitrate": args.bitrate,
        "fps": args.fps,
        "crf": args.crf,
        "preset": args.preset,
        "tune": args.tune,
        "gop": args.gop,
        "profile": args.profile,
        "level": args.level,
        "threads": args.threads,
        "audio_bitrate": args.audio_bitrate,
        "sample_rate": args.sample_rate,
        "channels": args.channels,
        "bit_depth_policy": args.bit_depth_policy,
        "lut_interp": args.interp,
        "zscale_dither": args.zscale_dither,
        "lut_input_matrix": args.lut_input_matrix,
        "lut_output_tags": args.lut_output_tags,
    }
    for attr, value in mapping.items():
        if value is not None:
            setattr(base, attr, value)
    if args.faststart is not None:
        base.faststart = args.faststart
    if args.cover is not None:
        base.generate_cover = args.cover
    if args.no_force_cfr:
        base.force_cfr = False
    if args.no_inherit_metadata:
        base.inherit_color_metadata = False
    return base


def cmd_render(args) -> int:
    from ..tasks import TaskManager

    device = resolve_device(args.device)
    params = _params_from_args(args)
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
        return _print_plans(batch.tasks)
    if lut:
        remember_lut(lut)

    manager = TaskManager(max_concurrency=args.concurrency,
                          lut_strategy=args.lut_strategy,
                          profile_dir=args.profile, device=device)
    for task in batch.tasks:
        manager.add_task(task)
    return _run_queue(manager, args)


def _print_plans(tasks) -> int:
    """--dry-run: print each task's stage plans without executing — the
    rebuild's analog of the reference logging the assembled FFmpeg command
    and its decision notes (task_manager.py:82-84)."""
    from ..plan import build_pipeline, build_render_spec

    for task in tasks:
        print(f"{task.display_name()}:")
        for i, stage in enumerate(build_pipeline(task)):
            spec = build_render_spec(
                stage.source_path, stage.output_path, stage.params,
                lut_path=stage.lut_path, source_info=task.source_info,
                notes=stage.notes,
            )
            print(f"  stage {i + 1}: {stage.name}")
            print(f"    {stage.source_path} -> {stage.output_path}")
            print(f"    codec={spec.video_codec} pix_fmt={spec.pix_fmt or 'auto'} "
                  f"fps_mode={spec.fps_mode} gop={spec.gop} "
                  f"bitrate={spec.bitrate or '-'} maxrate={spec.maxrate or '-'}")
            if spec.filters:
                print(f"    pixel pipeline: {', '.join(repr(f) for f in spec.filters)}")
            t = spec.color_tags
            if t.any():
                print(f"    tags: primaries={t.primaries} trc={t.trc} "
                      f"colorspace={t.colorspace} range={t.range}")
            for note in spec.notes:
                print(f"    note: {note}")
    return 0


def _run_queue(manager, args) -> int:
    names = {t.task_id: t.display_name() for t in manager.tasks.values()}
    watch = bool(getattr(args, "watch", False))

    def on_log(task_id, message):
        stamp = time.strftime("%H:%M:%S")
        print(f"[{stamp}] [{names.get(task_id, task_id)[:24]}] {message}")

    def on_progress(task_id, pct):
        if args.progress:
            # overall = mean progress across the queue (the reference's
            # window-title/taskbar aggregation, main_window.py:331-371)
            tasks = list(manager.tasks.values())
            overall = sum(t.progress for t in tasks) // max(1, len(tasks))
            print(f"[{names.get(task_id, task_id)[:24]}] {pct}%  "
                  f"(queue {overall}%)", flush=True)

    if not watch:  # line logs would corrupt the monitor's in-place frame
        manager.task_log.connect(on_log)
        manager.task_progress.connect(on_progress)
    manager.start_all()
    try:
        if watch:
            from .monitor import QueueMonitor

            QueueMonitor(manager).run()
            manager.wait_all()
        else:
            manager.wait_all()
    except KeyboardInterrupt:
        # first Ctrl-C: cooperative cancel (in-flight stages stop at the next
        # batch; partial outputs/masters are cleaned up by the runners)
        print("\ncanceling queue...", file=sys.stderr)
        for task_id in list(manager.tasks):
            manager.cancel_task(task_id)
        try:
            manager.wait_all(timeout=120)
        except KeyboardInterrupt:
            print("force exit", file=sys.stderr)

    if getattr(args, "save_queue", None):
        manager.save_queue(args.save_queue)
        print(f"queue state saved to {args.save_queue}")

    failed = [t for t in manager.tasks.values() if t.status.value == "failed"]
    done = [t for t in manager.tasks.values() if t.status.value == "completed"]
    if getattr(args, "notify", False):
        _notify_queue_finished(len(done), len(failed))
    print(f"queue finished: {len(done)} completed, {len(failed)} failed")
    for t in failed:
        print(f"  FAILED {t.display_name()}: {t.error}", file=sys.stderr)
    for t in done:
        print(f"  OK {t.display_name()} -> {t.output_path}")
    return 1 if failed else 0


def _notify_queue_finished(done: int, failed: int) -> None:
    """Completion notification — the headless analog of the reference's
    tray/toast on queue finish (main_window.py:377-421): a terminal bell
    always, plus a desktop notification when `notify-send` exists."""
    import shutil
    import subprocess

    sys.stdout.write("\a")
    sys.stdout.flush()
    exe = shutil.which("notify-send")
    if exe:
        body = f"{done} completed" + (f", {failed} failed" if failed else "")
        try:
            subprocess.run([exe, "lut-tpu queue finished", body], timeout=5)
        except Exception:
            pass


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
        from ..hostio.ffi import get_ffi

        get_ffi()
        report("hostio FFmpeg libs", True, "layout verified")
    except Exception as exc:  # a probe: any failure means it cannot load
        report("hostio FFmpeg libs", False, str(exc)[:80])
    print("overall:", "ok" if ok else "problems found")
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lut-torch",
        description="PyTorch/CUDA batch video 3D-LUT processor",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    render = sub.add_parser("render", help="process files through the pipeline")
    render.add_argument("files", nargs="+")
    render.add_argument("--lut", help=".cube LUT to apply")
    render.add_argument("--out-dir", help="output dir (default <src>/output)")
    render.add_argument("--master-dir", help="pro-mode master cache dir")
    render.add_argument("--concurrency", type=int, default=1,
                        help="parallel tasks (1-16, default 1)")
    render.add_argument("--progress", action="store_true")
    render.add_argument("--watch", action="store_true",
                        help="interactive queue monitor: live per-task rows, "
                             "1-9 cancels a task, a cancels all, q quits")
    render.add_argument("--notify", action="store_true",
                        help="terminal bell + desktop notification when the "
                             "queue finishes")
    render.add_argument("--lut-strategy", choices=["mxu", "gather"],
                        default="mxu", help=argparse.SUPPRESS)
    render.add_argument("--save-queue", help="write queue state JSON when done")
    render.add_argument("--profile", help="write a torch profiler trace to DIR")
    render.add_argument("--dry-run", action="store_true",
                        help="print the stage plans and policy notes, don't run")
    render.add_argument("--device", default="cuda",
                        help="cuda, cuda:N, or cpu (default cuda)")
    _add_param_flags(render)
    render.set_defaults(fn=cmd_render)

    doctor = sub.add_parser("doctor", help="environment health check")
    doctor.set_defaults(fn=cmd_doctor)
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
