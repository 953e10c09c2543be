"""The port's serving and interactive entry points on device="cpu",
mirroring tests/test_server.py, test_webui.py, test_tui.py and
test_app.py: the QueueServer protocol over a Unix socket (jobs render
through the port, a resize included), the web UI (and its two loopback
fixes: Host and Origin "127.evil.com" are refused, "[::1]" is accepted),
the TUI session, and the CLI's serve/client/resume/luts/probe/thumb/icon/
help subcommands."""

import json
import re
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from lut_renderer_tpu_torch.app import cli, remember_lut
from lut_renderer_tpu_torch.app import webui as webui_mod
from lut_renderer_tpu_torch.app.server import QueueServer, request
from lut_renderer_tpu_torch.app.tui import InteractiveSession
from lut_renderer_tpu_torch.app.webui import WebUI
from lut_renderer_tpu_torch.colorcore import write_cube_file
from lut_renderer_tpu_torch.hostio import probe_video
from lut_renderer_tpu_torch.models import TaskStatus
from lut_renderer_tpu_torch.tasks import TaskManager
from lut_renderer_tpu_torch.utils.fixtures import make_gradient_clip

from torch_parity import random_lut

JOB = {"video_codec": "mpeg4", "bitrate": "1M"}


@pytest.fixture(autouse=True)
def isolated_config(tmp_path, monkeypatch):
    monkeypatch.setenv("LUT_TPU_CONFIG_DIR", str(tmp_path / "config"))
    monkeypatch.setenv("LUT_TPU_THUMB_DIR", str(tmp_path / "thumbs"))


@pytest.fixture()
def media(tmp_path):
    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 48, fps=25.0, frames=5)
    cube = write_cube_file(tmp_path / "l.cube", random_lut(9, seed=51))
    return clip, cube


@pytest.fixture()
def served(tmp_path, media):
    sock = tmp_path / "lut.sock"
    server = QueueServer(sock, max_concurrency=2, lut_strategy="gather",
                         device="cpu")
    server.start()
    yield (server, sock, *media, tmp_path)
    server.stop()


def _wait_done(sock, task_ids, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        resp = request(sock, {"op": "status"})
        assert resp["ok"]
        by_id = {t["task_id"]: t for t in resp["tasks"]}
        if {by_id[t]["status"] for t in task_ids} <= {
                "completed", "failed", "canceled"}:
            return by_id
        time.sleep(0.05)
    raise AssertionError("queue did not drain")


# ---- server ---------------------------------------------------------------

def test_serve_submit_resize_status_complete(served):
    server, sock, clip, cube, tmp = served
    assert server.manager._device == "cpu"
    assert request(sock, {"op": "ping"}) == {"ok": True, "tasks": 0}
    resp = request(sock, {"op": "submit", "files": [str(clip)],
                          "lut": str(cube), "out_dir": str(tmp / "out"),
                          "params": dict(JOB, resolution="32x24")})
    assert resp["ok"], resp
    (tid,) = resp["task_ids"]
    by_id = _wait_done(sock, [tid])
    assert by_id[tid]["status"] == "completed", by_id[tid]["error"]
    info = probe_video(Path(by_id[tid]["output"]))
    assert (info.width, info.height) == (32, 24)
    one = request(sock, {"op": "status", "task_id": tid})
    assert one["ok"] and one["task"]["progress"] == 100
    assert any("engine: 64x48 -> 32x24" in m for m in one["task"]["logs"])
    assert one["task"]["source_info"]["width"] == 64


def test_serve_errors_and_cancel(served):
    server, sock, clip, cube, tmp = served
    assert not request(sock, {"op": "nope"})["ok"]
    assert not request(sock, {"op": "submit", "files": []})["ok"]
    assert not request(sock, {"op": "submit", "files": [str(clip)],
                              "lut": "/missing.cube"})["ok"]
    assert not request(sock, {"op": "cancel", "task_id": "ghost"})["ok"]
    assert not request(sock, {"op": "status", "task_id": "ghost"})["ok"]
    assert request(sock, {"op": "config", "concurrency": 99}) == {
        "ok": True, "concurrency": 16}


def test_serve_reprocess_and_clear(served):
    server, sock, clip, cube, tmp = served
    resp = request(sock, {"op": "submit", "files": [str(clip)],
                          "lut": str(cube), "out_dir": str(tmp / "outr")})
    (tid,) = resp["task_ids"]
    first = _wait_done(sock, [tid])[tid]
    assert first["status"] == "completed", first["error"]
    codec = server.manager.tasks[tid].params.video_codec
    rep = request(sock, {"op": "reprocess", "task_id": tid,
                         "params": {"lut_interp": "trilinear"}})
    assert rep["ok"], rep
    assert server.manager.tasks[tid].params.video_codec == codec
    second = _wait_done(sock, [tid])[tid]
    assert second["status"] == "completed"
    assert second["output"] != first["output"]
    assert request(sock, {"op": "clear"}) == {"ok": True, "removed": 1}


def test_serve_shutdown_cancels_and_refuses(served):
    server, sock, clip, cube, tmp = served
    resp = request(sock, {"op": "shutdown"})
    assert resp["ok"] and "_then_shutdown" not in resp
    assert server.shutdown_requested.wait(5)
    assert not server.handle_request(
        {"op": "submit", "files": [str(clip)]})["ok"]
    server.wait()


def test_serve_queue_file_restart_recovery(tmp_path, media):
    clip, cube = media
    qf, sock = tmp_path / "queue.json", tmp_path / "a.sock"
    server = QueueServer(sock, device="cpu", queue_file=qf)
    server.start()
    resp = request(sock, {"op": "submit", "files": [str(clip)],
                          "lut": str(cube), "params": JOB,
                          "out_dir": str(tmp_path / "out")})
    (tid,) = resp["task_ids"]
    _wait_done(sock, [tid])
    server.stop()
    saved = json.loads(qf.read_text())
    assert saved["tasks"][0]["status"] == "completed"
    saved["tasks"][0]["status"] = "running"  # a crash mid-run
    qf.write_text(json.dumps(saved))
    sock2 = tmp_path / "b.sock"
    server2 = QueueServer(sock2, device="cpu", queue_file=qf)
    server2.start()
    try:
        assert not server2.restore_error
        assert _wait_done(sock2, [tid])[tid]["status"] == "completed"
    finally:
        server2.stop()


# ---- web UI ---------------------------------------------------------------

@pytest.fixture()
def web(tmp_path, media):
    server = QueueServer(tmp_path / "unused.sock", max_concurrency=2,
                         device="cpu")
    ui = WebUI(server, port=0, settings={})
    ui.start()
    yield (ui, *media, tmp_path)
    ui.stop()


def _get(ui, path, raw=False):
    with urllib.request.urlopen(ui.url.rstrip("/") + path, timeout=30) as r:
        body = r.read()
        return (r.headers.get("Content-Type"), body) if raw \
            else json.loads(body)


def _status_of(req):
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as err:
        return err.code


def _post(base, headers, op="clear"):
    return urllib.request.Request(
        base + "/api/op", data=json.dumps({"op": op}).encode(),
        method="POST", headers={"Content-Type": "application/json",
                                **headers})


def test_web_page_meta_and_submit(web):
    ui, clip, cube, tmp = web
    ctype, body = _get(ui, "/", raw=True)
    assert ctype.startswith("text/html") and "/api/op" in body.decode()
    meta = _get(ui, "/api/meta")
    assert meta["ok"] and meta["concurrency"] == 2
    req = urllib.request.Request(
        ui.url.rstrip("/") + "/api/op", method="POST",
        data=json.dumps({"op": "submit", "files": [str(clip)],
                         "lut": str(cube), "params": JOB,
                         "out_dir": str(tmp / "out")}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        resp = json.loads(r.read())
    assert resp["ok"], resp
    (tid,) = resp["task_ids"]
    assert ui.queue.manager.wait_all(timeout=120)
    one = _get(ui, f"/api/task?id={tid}")
    assert one["task"]["status"] == "completed", one["task"]["error"]
    assert str(cube) in _get(ui, "/api/meta")["luts"]  # Start remembers it


def test_web_host_and_origin_gates(web):
    """The loopback fixes of the port's copy: Host and Origin
    "127.evil.com" are refused (the original's startswith("127.")
    accepted them), "[::1]" and other loopback addresses are accepted
    (the original's rsplit cut "[::1]" to "[:")."""
    ui = web[0]
    base = ui.url.rstrip("/")
    port = ui.port

    def get(host):
        return _status_of(urllib.request.Request(base + "/api/meta",
                                                 headers={"Host": host}))

    assert get(f"127.evil.com:{port}") == 403
    assert get("127.evil.com") == 403
    assert get("evil.example") == 403
    assert get(f"[::1]:{port}") == 200
    assert get("[::1]") == 200
    assert get(f"127.0.0.2:{port}") == 200
    assert get(f"LOCALHOST:{port}") == 200
    assert _status_of(_post(base, {"Origin": "http://127.evil.com"})) == 403
    assert _status_of(_post(base, {"Origin": "https://evil.example"})) == 403
    assert _status_of(_post(base, {"Origin": f"http://[::1]:{port}",
                                   "Host": f"[::1]:{port}"})) == 200
    assert _status_of(_post(base, {"Origin": f"http://127.0.0.1:{port}"})) \
        == 200
    form = urllib.request.Request(base + "/api/op", data=b"{}",
                                  method="POST",
                                  headers={"Content-Type": "text/plain"})
    assert _status_of(form) == 415


@pytest.mark.parametrize("host,loopback", [
    ("127.0.0.1", True), ("localhost", True), ("::1", True),
    ("[::1]", True), ("127.0.0.9", True), ("127.evil.com", False),
    ("127.", False), ("0.0.0.0", False), ("evil.example", False),
    ("", False)])
def test_is_loopback(host, loopback):
    assert webui_mod._is_loopback(host) is loopback


@pytest.mark.parametrize("netloc,name", [
    ("127.0.0.1:8080", "127.0.0.1"), ("[::1]:8080", "::1"), ("[::1]", "::1"),
    ("Render-Box.lan:80", "render-box.lan"), ("127.evil.com", "127.evil.com"),
    ("[::1", ""), ("", "")])
def test_host_name(netloc, name):
    assert webui_mod._host_name(netloc) == name


def test_web_token_and_bind_rules(tmp_path):
    server = QueueServer(tmp_path / "t.sock", device="cpu")
    for host in ("0.0.0.0", "127.evil.com"):
        with pytest.raises(ValueError, match="http-token"):
            WebUI(server, host=host, port=0, settings={})
    ui = WebUI(server, host="0.0.0.0", port=0, settings={}, token="tk")
    ui.start()
    try:
        base = f"http://127.0.0.1:{ui.port}"
        lan = {"X-Auth-Token": "tk", "Host": "render-box.lan:8080"}
        assert _status_of(_post(base, dict(
            lan, Origin="http://render-box.lan:8080"))) == 200
        assert _status_of(_post(base, dict(
            lan, Origin="https://evil.example"))) == 403
        assert _status_of(_post(base, {"Origin": "http://127.0.0.1"})) == 401
    finally:
        ui.stop()


# ---- TUI ------------------------------------------------------------------

def test_tui_session_add_lut_start(tmp_path, media):
    clip, cube = media
    mgr = TaskManager(max_concurrency=1, device="cpu")
    s = InteractiveSession(mgr, out_dir=tmp_path / "out", settings={})
    s.on_key("a")
    for ch in str(clip):
        s.on_key(ch)
    s.on_key("\r")
    (task,) = mgr.tasks.values()
    assert task.params.resolution == "64x48"  # smart default from probe
    s.on_key("l")
    s.on_key("n")
    for ch in str(cube):
        s.on_key(ch)
    s.on_key("\r")
    assert s.lut_path == cube
    s.params.video_codec = "mpeg4"
    s.on_key("s")
    assert mgr.wait_all(timeout=120)
    assert task.status == TaskStatus.COMPLETED, task.error
    assert task.output_path.exists()
    for mode in ("queue", "edit", "luts", "presets", "help"):
        s.mode = mode
        assert s.render()


# ---- CLI ------------------------------------------------------------------

# what the serve thread prints ("lut-torch serve: stopped") can land in
# the same captured stdout as the client's JSON reply, before or after it
SERVE_LINE = re.compile(r"lut-torch serve: [^\n{]*")


def _client(sock, req, capsys, served=None):
    """The client's exit code and JSON reply; the serve thread's own lines
    in the same capture are set aside into `served`."""
    rc = cli.main(["client", json.dumps(req), "--socket", str(sock)])
    out = capsys.readouterr().out
    if served is not None:
        served.extend(SERVE_LINE.findall(out))
    return rc, json.loads(SERVE_LINE.sub("", out))


def test_cli_serve_warmup_client_shutdown(tmp_path, capsys):
    sock = tmp_path / "s.sock"
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(cli.main(
        ["serve", "--socket", str(sock), "--device", "cpu", "--warmup"])))
    t.start()
    out, deadline = "", time.time() + 60
    while "serving on" not in out and time.time() < deadline:
        time.sleep(0.05)
        out += capsys.readouterr().out
    assert "warmup: kernel A + resample" in out and sock.exists()
    rc, resp = _client(sock, {"op": "ping"}, capsys)
    assert rc == 0 and resp == {"ok": True, "tasks": 0}
    rc, resp = _client(sock, {"op": "status"}, capsys)
    assert rc == 0 and resp["tasks"] == []
    rc, resp = _client(sock, {"op": "nope"}, capsys)
    assert rc == 1 and not resp["ok"]
    served = []
    rc, resp = _client(sock, {"op": "shutdown"}, capsys, served)
    assert rc == 0
    t.join(timeout=60)
    assert not t.is_alive() and rcs == [0]
    assert "serve: stopped" in "\n".join(served) + capsys.readouterr().out
    assert cli.main(["client", "{bad", "--socket", str(sock)]) == 2
    assert cli.main(["client", "{}", "--socket", str(sock)]) == 2  # gone


def test_cli_resume_redo_reapply_with_resize(tmp_path, media, capsys):
    clip, cube = media
    queue = tmp_path / "q.json"
    rc = cli.main(["render", str(clip), "--lut", str(cube), "--out-dir",
                   str(tmp_path / "out"), "--codec", "mpeg4", "--device",
                   "cpu", "--save-queue", str(queue)])
    assert rc == 0
    first = json.loads(queue.read_text())["tasks"][0]
    assert first["status"] == "completed"
    capsys.readouterr()
    rc = cli.main(["resume", str(queue), "--redo", "--reapply", "--codec",
                   "mpeg4", "--resolution", "32x24", "--device", "cpu",
                   "--save-queue", str(queue)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "re-enqueued 1 finished task(s)" in out
    assert "re-applied current settings to 1 pending task(s)" in out
    task = json.loads(queue.read_text())["tasks"][0]
    assert task["status"] == "completed"
    assert task["output_path"] != first["output_path"]
    info = probe_video(Path(task["output_path"]))
    assert (info.width, info.height) == (32, 24)
    # nothing pending: resume returns at once
    assert cli.main(["resume", str(queue), "--device", "cpu"]) == 0


def test_cli_luts_gate_and_history(tmp_path, media, capsys):
    _, cube = media
    assert cli.main(["luts", "gate", str(cube)]) == 0
    out = capsys.readouterr().out
    assert "l.cube: 9^3  tetrahedral=exact (dE76 0.000)  " \
           "trilinear=exact (dE76 0.000)  [" in out
    assert cli.main(["luts", "gate", str(tmp_path / "missing.cube")]) == 1
    assert "FAILED" in capsys.readouterr().out
    remember_lut(cube)
    assert cli.main(["luts", "list", "--filter", "l.cube"]) == 0
    assert str(cube) in capsys.readouterr().out


def test_cli_probe_thumb_icon_help_presets_encoders(tmp_path, media,
                                                    capsys):
    clip, _ = media
    assert cli.main(["probe", str(clip), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["width"] == 64
    assert cli.main(["probe", str(tmp_path / "missing.mp4")]) == 1
    capsys.readouterr()
    assert cli.main(["thumb", str(clip), "--width", "32"]) == 0
    assert Path(capsys.readouterr().out.strip()).exists()
    assert cli.main(["icon", "--out", str(tmp_path / "icons")]) == 0
    assert (tmp_path / "icons" / "lut-tpu_16.png").exists()
    capsys.readouterr()
    assert cli.main(["help", "resolution"]) == 0
    assert "swscale" in capsys.readouterr().out
    assert cli.main(["help", "nope"]) == 1
    assert cli.main(["presets", "save", "x", "--params-json",
                     json.dumps({"bitrate": "3M"})]) == 0
    assert cli.main(["presets", "save", "x", "--params-json", "{}"]) == 2
    capsys.readouterr()
    assert cli.main(["presets", "show", "x"]) == 0
    assert "3M" in capsys.readouterr().out
    assert cli.main(["encoders"]) == 0
    assert "mpeg4" in capsys.readouterr().out.split()


def test_cli_tui_and_serve_need_a_device(capsys):
    """Every subcommand that renders takes --device; "cuda" without a card
    raises before anything starts (no CPU fallback)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["serve", "--socket", "x.sock"], ["tui"],
                 ["resume", "q.json"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert cli.main(["doctor", "--warmup"]) == 1
    assert "warmup" in capsys.readouterr().out
