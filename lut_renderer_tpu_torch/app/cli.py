"""lut-torch: the port's CLI, the JAX package's `lut-tpu` subcommands over
the PyTorch/CUDA pipeline.

  render    queue files through the pipeline (fast or pro mode);
            --watch opens the live queue monitor, --notify rings on finish
  resume    re-run a saved queue (--reapply fresh params, --redo finished)
  serve     warm render daemon over a Unix socket (JSON-lines protocol),
            optionally with the web GUI (--http)
  client    send one request to a running daemon
  tui       interactive terminal UI
  probe     print probe info for files (ffprobe-replacement output)
  presets   list / show / save / delete / rename parameter presets
  luts      show / clean / filter the LUT history; gate = the tier each
            LUT renders at
  encoders  list encoders available in the bundled libraries
  thumb     generate a cached thumbnail for a file
  icon      write the app icon PNG set
  doctor    environment health check: torch, CUDA, nvcc, the card, hostio
  help      per-parameter help topics

Every subcommand keeps the JAX parser's flags (tests/test_torch_hostside.py
holds them to it); the ones that render add ``--device`` (default ``cuda``:
a missing card is an error, never a CPU fallback; plain ``cuda`` splits the
frame batch across the cards where there are several, ``cuda:N`` pins
one). The warmups (`serve --warmup`, `doctor --warmup`) build the kernels
and run each once (engine.warmup); there is no compile cache to fill.

    python -m lut_renderer_tpu_torch.app.cli render clip.mp4 --lut look.cube
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..device import resolve_device
from ..models import ProcessingParams
from . import (
    cleanup_lut_history,
    ensure_thumbnail,
    load_settings,
    lut_history,
    remember_lut,
    save_settings,
)
from . import presets as presets_mod
from .defaults import mode_template
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

    resolve_device(args.device)
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
                          profile_dir=args.profile,
                          device=args.device)
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


def cmd_resume(args) -> int:
    """Resume a saved queue: PENDING (and interrupted RUNNING) tasks run.

    --reapply re-snapshots the CLI's current parameter flags onto every
    pending task before starting (smart defaults re-run per source, fresh
    output paths) — the reference's apply-settings-to-pending-on-Start
    behavior (main_window.py:2557-2612)."""
    from ..tasks import TaskManager

    resolve_device(args.device)
    manager = TaskManager(max_concurrency=args.concurrency,
                          lut_strategy=args.lut_strategy, device=args.device)
    n = manager.load_queue(args.queue_file)
    if args.redo:
        # re-enqueue finished tasks with fresh output names (the reference's
        # per-row reprocess, applied queue-wide); pending ones are untouched
        finished = [tid for tid, t in manager.tasks.items()
                    if t.status.value in ("completed", "failed", "canceled")]
        redone = sum(1 for tid in finished if manager.reprocess_task(tid))
        print(f"re-enqueued {redone} finished task(s)")
    pending = sum(1 for t in manager.tasks.values() if t.status.value == "pending")
    print(f"loaded {n} tasks ({pending} pending)")
    if not pending:
        return 0
    if args.reapply:
        params = _params_from_args(args)
        lut = Path(args.lut) if getattr(args, "lut", None) else None
        if lut and not lut.exists():
            print(f"error: LUT not found: {lut}", file=sys.stderr)
            return 2
        changed = manager.apply_params_to_pending(params, lut_path=lut)
        print(f"re-applied current settings to {changed} pending task(s)")
    return _run_queue(manager, args)


def cmd_probe(args) -> int:
    from ..hostio import probe_video

    status = 0
    for f in args.files:
        try:
            info = probe_video(Path(f))
        except Exception as exc:
            print(f"{f}: error: {exc}", file=sys.stderr)
            status = 1
            continue
        if args.json:
            print(json.dumps({
                k: v for k, v in dataclasses.asdict(info).items() if v is not None
            }, default=str))
        else:
            print(f"{f}:")
            if info.codec_name:
                print(f"  video: {info.codec_name} {info.resolution} "
                      f"{info.pix_fmt} {info.bit_depth}bit "
                      f"{info.fps if info.fps else '?'}fps"
                      f"{' VFR' if info.is_vfr else ''}")
                print(f"  color: matrix={info.colorspace} primaries="
                      f"{info.color_primaries} trc={info.color_trc} "
                      f"range={info.color_range}")
            else:
                print("  video: none")
            print(f"  duration: {info.duration}s  bitrate: {info.bitrate}  "
                  f"frames: {info.nb_frames}")
            if info.audio_codec:
                print(f"  audio: {info.audio_codec} "
                      f"{info.audio_sample_rate}Hz ch={info.audio_channels} "
                      f"{info.audio_bitrate}")
            if info.video_tags:
                tags = ", ".join(f"{k}={v}" for k, v in list(info.video_tags.items())[:6])
                print(f"  tags: {tags}")
        if args.exiftool:
            _print_exiftool(f)
    return status


def _print_exiftool(path) -> None:
    """Optional exiftool metadata, graceful on absence (reference:
    main_window.py:2167-2186 shows exiftool output in the detail dialog only
    when the binary exists)."""
    import shutil
    import subprocess

    exe = shutil.which("exiftool")
    if not exe:
        print("  exiftool: not installed", file=sys.stderr)
        return
    try:
        result = subprocess.run(
            [exe, "-S", str(path)], capture_output=True, text=True, timeout=30
        )
        for line in result.stdout.splitlines()[:40]:
            print(f"  exif: {line}")
    except Exception as exc:
        print(f"  exiftool failed: {exc}", file=sys.stderr)


def cmd_presets(args) -> int:
    if args.action == "list":
        for name in presets_mod.list_presets():
            print(name)
    elif args.action == "show":
        print(json.dumps(presets_mod.load_preset(args.name).to_dict(), indent=2))
    elif args.action == "save":
        params = ProcessingParams.from_dict(json.loads(args.params_json or "{}"))
        try:
            presets_mod.save_preset(args.name, params)
        except FileExistsError:
            if args.force:
                presets_mod.overwrite_preset(args.name, params)
            else:
                print(f"error: preset exists (use --force): {args.name}",
                      file=sys.stderr)
                return 2
        print(f"saved {args.name}")
    elif args.action == "delete":
        presets_mod.delete_preset(args.name)
    elif args.action == "rename":
        presets_mod.rename_preset(args.name, args.new_name)
    return 0


def cmd_luts(args) -> int:
    if args.action == "gate":
        return _gate_luts(args)
    if args.action == "clean":
        cleanup_lut_history()
    needle = (args.filter or "").lower()
    for i, path in enumerate(lut_history()):
        if needle and needle not in str(path).lower():
            continue  # the reference's history filter box
        mark = "*" if i == 0 else " "
        print(f"{mark} {path}")
    return 0


def _gate_luts(args) -> int:
    """The tier each LUT of a library renders at (ops.render.lut_tier), in
    the JAX command's format. The port runs no per-LUT precision gate:
    "auto" renders the exact table, whose error against the LUT is 0."""
    from ..colorcore.cube import parse_cube_file
    from ..ops.render import RenderConfig, lut_tier

    paths = [Path(p) for p in (args.paths or [])]
    if not paths:
        needle = (args.filter or "").lower()
        paths = [Path(p) for p in lut_history()
                 if not needle or needle in str(p).lower()]
    if not paths:
        print("no LUTs given and history is empty "
              "(usage: luts gate [paths...])")
        return 1
    failed = 0
    for path in paths:
        try:
            t0 = time.perf_counter()
            size = parse_cube_file(path).size
            tier = lut_tier(RenderConfig().lut_precision, size)
            tiers = [f"{interp}={tier} (dE76 0.000)"
                     for interp in ("tetrahedral", "trilinear")]
            dt = time.perf_counter() - t0
            print(f"  {path.name}: {size}^3  "
                  f"{'  '.join(tiers)}  [{dt:.2f}s]")
        except Exception as exc:
            failed += 1
            print(f"  {path}: FAILED {str(exc)[:120]}")
    return 1 if failed else 0


def cmd_encoders(args) -> int:
    from ..hostio import list_encoders

    for name in list_encoders():
        print(name)
    return 0


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
    if args.warmup:
        print("warmup:")
        try:
            recs = _warmup(args.device)
        except (RuntimeError, ValueError) as exc:  # no such device
            report("warmup", False, str(exc)[:80])
        else:
            ok = ok and all(r["ok"] for r in recs)
    print("overall:", "ok" if ok else "problems found")
    return 0 if ok else 1


def _warmup(device):
    """Build the kernels and run each path once on `device`
    (engine.warmup), printing a line a step."""
    from ..engine.warmup import warmup_kernels

    return warmup_kernels(device, log=lambda m: print("  " + m, flush=True))


def cmd_serve(args) -> int:
    """Warm render daemon: owns the card, keeps the built kernels, render
    functions and uploaded LUTs resident, accepts JSON-lines jobs over a
    Unix socket (app.server). Per-job cost becomes pure render time
    instead of process startup and kernel build."""
    import threading

    from .server import QueueServer

    resolve_device(args.device)
    if args.warmup_background:
        # serve at once; the kernels build behind the queue (a job that
        # comes first builds them itself)
        def _bg_warm():
            recs = _warmup(args.device)
            print(f"background warmup done: "
                  f"{sum(r['ok'] for r in recs)}/{len(recs)} steps",
                  flush=True)

        print("warming the kernels in the background")
        threading.Thread(target=_bg_warm, daemon=True,
                         name="lut-torch-warmup").start()
    elif args.warmup:
        print("warming the kernels (build, then one launch of each):")
        _warmup(args.device)
    server = QueueServer(args.socket, max_concurrency=args.concurrency,
                         lut_strategy=args.lut_strategy,
                         queue_file=args.queue_file, device=args.device)
    if server.restore_error:
        print(f"warning: {server.restore_error}", file=sys.stderr)
    elif server.queue_file and server.manager.tasks:
        print(f"restored {len(server.manager.tasks)} task(s) from "
              f"{server.queue_file}")
    server.start()
    web = None
    if args.http is not None:
        from .webui import WebUI

        token = args.http_token
        if token == "auto":
            import secrets

            token = secrets.token_urlsafe(16)
        try:
            web = WebUI(server, host=args.http_host, port=args.http,
                        token=token)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            server.stop()
            return 2
        web.start()
        print(f"web GUI on {web.url}"
              + (f"?token={token}" if token else ""))
    print(f"lut-torch serving on {args.socket} "
          f"(concurrency {args.concurrency}, device {args.device}); "
          f"send {{\"op\": \"shutdown\"}} to stop", flush=True)
    try:
        server.shutdown_requested.wait()
    except KeyboardInterrupt:
        print("\nshutting down", file=sys.stderr)
        server._draining = True  # refuse new submits during the drain
        for task_id in list(server.manager.tasks):
            server.manager.cancel_task(task_id)
    # stop the web UI BEFORE draining: no new state changes (browser
    # submits) may land while the daemon is tearing down
    if web is not None:
        web.stop()
    server.manager.wait_all(timeout=120)
    server.stop()
    print("lut-torch serve: stopped", flush=True)
    return 0


def cmd_tui(args) -> int:
    """Interactive terminal UI — the headless main window: add files, edit
    every parameter with inline help, LUT history picker, presets,
    start/reprocess/cancel (app.tui)."""
    from ..tasks import TaskManager
    from .tui import InteractiveSession, InteractiveTui

    settings = load_settings()
    lut = Path(args.lut) if args.lut else None
    if lut is None and settings.get("last_lut"):
        remembered = Path(settings["last_lut"])
        if remembered.exists():
            lut = remembered
    resolve_device(args.device)
    manager = TaskManager(max_concurrency=args.concurrency,
                          lut_strategy=args.lut_strategy, device=args.device)
    session = InteractiveSession(
        manager,
        lut_path=lut,
        out_dir=Path(args.out_dir) if args.out_dir else None,
        master_dir=Path(args.master_dir) if args.master_dir else None,
        settings=settings,
    )
    if args.files:
        session.add_path_list([Path(p) for p in args.files])
    tui = InteractiveTui(session)
    try:
        tui.run()
    finally:
        for task_id in list(manager.tasks):
            manager.cancel_task(task_id)
        manager.wait_all(timeout=60)
        save_settings(settings)
    return 0


def cmd_client(args) -> int:
    """Send one protocol request to a running `serve` daemon."""
    from .server import request

    try:
        payload = json.loads(args.request)
    except json.JSONDecodeError as exc:
        print(f"error: request is not valid JSON: {exc}", file=sys.stderr)
        return 2
    try:
        resp = request(args.socket, payload, timeout=args.timeout)
    except OSError as exc:
        print(f"error: cannot reach server at {args.socket}: {exc}",
              file=sys.stderr)
        return 2
    print(json.dumps(resp, indent=2))
    return 0 if resp.get("ok") else 1


def cmd_help(args) -> int:
    """Per-field help topics — the headless analog of the reference's help
    popup system (main_window.py:1269-1622)."""
    from .help import help_text

    text = help_text(args.topic)
    print(text)
    return 0 if not text.startswith("unknown topic") else 1


def cmd_thumb(args) -> int:
    out = ensure_thumbnail(Path(args.file), width=args.width)
    if out is None:
        print("error: could not generate thumbnail", file=sys.stderr)
        return 1
    print(out)
    return 0


def cmd_icon(args) -> int:
    """Generate the app icon PNG set (reference: icon.py paints it
    in-memory at 7 sizes with no asset files; headless analog writes
    the same motif as PNGs for packaging)."""
    from .icon import write_icon_pngs

    for p in write_icon_pngs(Path(args.out)):
        print(p)
    return 0


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (every card), cuda:N, or cpu (default cuda)")


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
    _add_device_flag(render)
    _add_param_flags(render)
    render.set_defaults(fn=cmd_render)

    resume = sub.add_parser("resume", help="resume a saved queue")
    resume.add_argument("queue_file")
    resume.add_argument("--concurrency", type=int, default=1)
    resume.add_argument("--progress", action="store_true")
    resume.add_argument("--watch", action="store_true",
                        help="interactive queue monitor (see render --watch)")
    resume.add_argument("--notify", action="store_true",
                        help="bell + desktop notification on queue finish")
    resume.add_argument("--save-queue", help="write queue state JSON when done")
    resume.add_argument("--lut-strategy", choices=["mxu", "gather"],
                        default="mxu", help=argparse.SUPPRESS)
    resume.add_argument("--reapply", action="store_true",
                        help="re-apply the current parameter flags to all "
                             "pending tasks before starting")
    resume.add_argument("--redo", action="store_true",
                        help="re-enqueue finished tasks too (fresh output "
                             "names; combine with --reapply for new params)")
    resume.add_argument("--lut", help=".cube LUT (with --reapply)")
    _add_param_flags(resume)
    _add_device_flag(resume)
    resume.set_defaults(fn=cmd_resume)

    probe = sub.add_parser("probe", help="print media info")
    probe.add_argument("files", nargs="+")
    probe.add_argument("--json", action="store_true")
    probe.add_argument("--exiftool", action="store_true",
                       help="append exiftool metadata when the tool exists")
    probe.set_defaults(fn=cmd_probe)

    presets = sub.add_parser("presets", help="manage presets")
    presets.add_argument("action",
                         choices=["list", "show", "save", "delete", "rename"])
    presets.add_argument("name", nargs="?")
    presets.add_argument("new_name", nargs="?")
    presets.add_argument("--params-json")
    presets.add_argument("--force", action="store_true")
    presets.set_defaults(fn=cmd_presets)

    luts = sub.add_parser("luts", help="LUT history")
    luts.add_argument("action", nargs="?", default="list",
                      choices=["list", "clean", "gate"])
    luts.add_argument("paths", nargs="*", default=[],
                      help="for `gate`: .cube files to pre-gate into the "
                           "persistent tier-gate cache (default: the "
                           "whole LUT history)")
    luts.add_argument("--filter", help="substring filter on history paths")
    luts.set_defaults(fn=cmd_luts)

    encoders = sub.add_parser("encoders", help="list available encoders")
    encoders.set_defaults(fn=cmd_encoders)

    thumb = sub.add_parser("thumb", help="generate a thumbnail")
    thumb.add_argument("file")
    thumb.add_argument("--width", type=int, default=160)
    thumb.set_defaults(fn=cmd_thumb)

    icon = sub.add_parser("icon", help="write the app icon PNG set")
    icon.add_argument("--out", default="dist/icons",
                      help="destination directory (default dist/icons)")
    icon.set_defaults(fn=cmd_icon)

    doctor = sub.add_parser("doctor", help="environment health check")
    doctor.add_argument("--warmup", action="store_true",
                        help="build the kernels and run each once")
    _add_device_flag(doctor)
    doctor.set_defaults(fn=cmd_doctor)

    serve = sub.add_parser("serve", help="warm render daemon (Unix socket)")
    serve.add_argument("--socket", required=True,
                       help="Unix socket path to listen on")
    serve.add_argument("--concurrency", type=int, default=1)
    serve.add_argument("--warmup", action="store_true",
                       help="build the kernels and run each once before "
                            "accepting jobs (cold-start protection)")
    serve.add_argument("--warmup-background", action="store_true",
                       help="like --warmup but serve immediately while the "
                            "kernels build behind the queue")
    serve.add_argument("--http", type=int, metavar="PORT",
                       help="also serve the web GUI (the browser analog of "
                            "the reference's main window) on this port; "
                            "0 picks a free port")
    serve.add_argument("--http-host", default="127.0.0.1",
                       help="web GUI bind address (default 127.0.0.1; "
                            "non-loopback binds require --http-token)")
    serve.add_argument("--http-token", metavar="TOKEN",
                       help="require this token on every web GUI request "
                            "(open /?token=TOKEN once; 'auto' generates "
                            "one and prints it). Mandatory for non-"
                            "loopback --http-host")
    serve.add_argument("--queue-file", metavar="PATH",
                       help="durable queue: restore on start (interrupted "
                            "tasks resume as pending) and persist on every "
                            "state change — daemon crash/restart recovery")
    serve.add_argument("--lut-strategy", choices=["mxu", "gather"],
                       default="mxu", help=argparse.SUPPRESS)
    _add_device_flag(serve)
    serve.set_defaults(fn=cmd_serve)

    tui = sub.add_parser("tui", help="interactive terminal UI (headless "
                                     "main window)")
    tui.add_argument("files", nargs="*", help="files/dirs to pre-queue")
    tui.add_argument("--lut", help=".cube LUT (defaults to last used)")
    tui.add_argument("--out-dir")
    tui.add_argument("--master-dir")
    tui.add_argument("--concurrency", type=int, default=1)
    tui.add_argument("--lut-strategy", choices=["mxu", "gather"],
                     default="mxu", help=argparse.SUPPRESS)
    _add_device_flag(tui)
    tui.set_defaults(fn=cmd_tui)

    client = sub.add_parser("client", help="send one request to a daemon")
    client.add_argument("request", help='JSON, e.g. {"op": "status"}')
    client.add_argument("--socket", required=True)
    client.add_argument("--timeout", type=float, default=60.0)
    client.set_defaults(fn=cmd_client)

    helpc = sub.add_parser("help", help="per-parameter help topics")
    helpc.add_argument("topic", nargs="?", default="")
    helpc.set_defaults(fn=cmd_help)
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
