"""Web GUI shell for the serve daemon — the browser analog of the
reference's Qt main window.

The port's copy of lut_renderer_tpu/app/webui.py over the port's
QueueServer, with two faults of the original fixed here (ROADMAP.md §3):
a loopback host is one of the exact loopback names or an address that
``ipaddress`` calls loopback (the original's ``startswith("127.")``
accepted ``127.evil.com`` as Host and as Origin), and the Host header's
name is parsed with ``urllib.parse.urlsplit`` (the original's
``rsplit(":", 1)`` cut ``[::1]`` to ``[:``).

The reference paints its GUI with PySide6/qt-material (reference
app.py:68-84, main_window.py:197 onward). PySide6 is not part of this
environment, and a desktop toolkit is the wrong shell for a headless TPU
deployment anyway — the machine that owns the chip is usually not the
machine with the screen. The GUI shell here is a zero-dependency web page
served by the daemon itself (`serve --http PORT`): the same
QueueServer process that keeps the jit executables warm serves a
single-page UI over stdlib ``http.server``, with the main window's
affordances mapped 1:1:

* add-tasks form with every ProcessingParams field, blank-means-auto, and
  per-field inline help (reference params panel main_window.py:450-903,
  help popups main_window.py:1269-1622);
* fast/pro mode templates (main_window.py:1078-1098);
* LUT history picker (lut_manager.py:120-186) — submitting remembers the
  LUT exactly like Start does (main_window.py:1824);
* presets load/save with the overwrite-confirmation contract
  (presets.py:37-42, main_window.py:2402-2419);
* live queue table with thumbnails, per-row progress, cancel, reprocess
  and an info view carrying the runtime log tail (queue table
  main_window.py:2188-2271, detail dialog main_window.py:1979-2119);
* aggregate queue progress in the header (the window-title/taskbar
  aggregation, main_window.py:331-371), clear-completed, shutdown.

The JSON API is a thin bridge onto the Unix-socket protocol
(app/server.py): ``POST /api/op`` passes the request object to
``QueueServer.handle_request`` unchanged, so everything the socket can do
the page can do.

Trust model (unlike the Unix socket, an HTTP port is reachable from any
web page the user's browser visits, so "binds 127.0.0.1" is not enough):

* every request's Host header must name the bound address (defeats DNS
  rebinding against the loopback bind);
* ``POST /api/op`` requires ``Content-Type: application/json`` (a browser
  cannot send that cross-origin without a CORS preflight, which we never
  answer — blocks blind no-cors CSRF posts) and, when an Origin header is
  present, it must be our own origin;
* optionally a per-daemon token (``serve --http-token``): required on
  every endpoint, supplied once as ``?token=`` (the page stores it in a
  SameSite=Strict cookie so links and fetches ride along). Non-loopback
  binds REQUIRE a token.
"""

from __future__ import annotations

import ipaddress
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse, urlsplit

from .. import __version__
from ..models import ProcessingParams
from .defaults import mode_template
from .help import help_text
from .lut_history import (
    cleanup_lut_history,
    last_lut,
    lut_history,
    remember_lut,
)
from .presets import (
    PresetError,
    PresetExistsError,
    delete_preset,
    list_presets,
    load_preset,
    overwrite_preset,
    rename_preset,
    save_preset,
)
from .server import QueueServer
from .webui_page import PAGE

# Body cap sized for LUT uploads: a 65^3 .cube is ~8 MB of text (129^3,
# the largest supported size, ~64 MB); everything else is tiny.
_MAX_BODY = 96 << 20

_LOOPBACK_NAMES = ("127.0.0.1", "localhost", "::1", "[::1]")


def _is_loopback(host: str) -> bool:
    """An exact loopback name, or a loopback IP address: "127.0.0.2" and
    "::1" are, "127.evil.com" is not."""
    if host in _LOOPBACK_NAMES:
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def _host_name(netloc: str) -> str:
    """The host name of a Host header or an authority ("[::1]:8080" ->
    "::1"), lower case; "" when it does not parse."""
    try:
        return urlsplit("//" + netloc).hostname or ""
    except ValueError:
        return ""


def _field_schema() -> list:
    """One entry per ProcessingParams field, with both mode-template
    defaults and the field's help topic (the reference's per-field popup
    text), so the page can render the full params panel data-driven."""
    import dataclasses

    fast = mode_template("fast").to_dict()
    pro = mode_template("pro").to_dict()
    bools = ProcessingParams._BOOL_FIELDS
    out = []
    for f in dataclasses.fields(ProcessingParams):
        if f.name.startswith("_"):
            continue
        help_body = help_text(f.name)
        if help_body.startswith("unknown topic"):
            help_body = ""
        out.append({
            "name": f.name,
            "bool": f.name in bools,
            "fast": fast[f.name],
            "pro": pro[f.name],
            "help": help_body,
        })
    return out


class WebUI:
    """HTTP front end over a QueueServer (plus app-layer stores).

    Owns nothing queue-related: all task operations go through
    ``queue_server.handle_request`` so behavior (and its tests) stay in one
    place. The web layer adds only read endpoints for the app stores
    (LUT history, presets, help, thumbnails) and preset saving.
    """

    def __init__(self, queue_server: QueueServer, host: str = "127.0.0.1",
                 port: int = 0, settings: Optional[dict] = None,
                 token: Optional[str] = None):
        self.queue = queue_server
        self.host = host
        self.token = token or None
        self._requested_port = port
        if not _is_loopback(host) and not self.token:
            raise ValueError(
                f"refusing to bind the web GUI on non-loopback {host!r} "
                "without --http-token: anyone who can reach the port could "
                "submit server-side paths")
        if settings is not None:
            self.settings = settings
            self._persist_settings = False
        else:
            from .settings import load_settings

            self.settings = load_settings()
            self._persist_settings = True
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # handler threads run concurrently; settings mutations (LUT
        # history, theme) are read-modify-write and need serializing
        self._settings_lock = threading.Lock()

    # -- app-layer ops ------------------------------------------------------
    def _meta(self) -> dict:
        return {
            "ok": True,
            "version": __version__,
            "fields": _field_schema(),
            "luts": lut_history(self.settings),
            "last_lut": last_lut(self.settings),
            "presets": list_presets(),
            "concurrency": self.queue.manager.max_concurrency,
            # default mirrors the reference's fresh-install theme (its
            # app.py themes dict defaults the ui_theme key to light)
            "ui_theme": self.settings.get("ui_theme", "light"),
        }

    def _set_theme(self, theme: str) -> dict:
        # persisted under the reference's own settings key (ui_theme,
        # reference app.py:77-81 theme select / main_window._apply_theme)
        if theme not in ("dark", "light"):
            return {"ok": False, "error": "theme must be dark or light"}
        with self._settings_lock:
            self.settings["ui_theme"] = theme
            if self._persist_settings:
                from .settings import save_settings

                save_settings(self.settings)
        return {"ok": True, "ui_theme": theme}

    def _save_preset(self, req: dict) -> dict:
        name = req.get("name", "")
        params = ProcessingParams.from_dict(dict(req.get("params") or {}))
        try:
            if req.get("overwrite"):
                overwrite_preset(name, params)
            else:
                save_preset(name, params)
        except PresetExistsError:
            return {"ok": False, "error": "exists",
                    "hint": "preset exists; set overwrite to replace it"}
        except (PresetError, OSError, ValueError) as exc:
            return {"ok": False, "error": str(exc)}
        return {"ok": True, "presets": list_presets()}

    def _load_preset(self, name: str) -> dict:
        try:
            return {"ok": True, "params": load_preset(name).to_dict()}
        except (PresetError, OSError, ValueError) as exc:
            return {"ok": False, "error": str(exc)}

    # -- LUT manager (reference LutManagerDialog, lut_manager.py:26-186) ----
    def _luts_view(self) -> dict:
        return {"ok": True,
                "luts": [{"path": p, "exists": Path(p).exists()}
                         for p in lut_history(self.settings)],
                "last": last_lut(self.settings)}

    def _select_lut(self, path: str) -> dict:
        # set-current moves the path to the history head (reference
        # lut_manager.py set-current semantics); require the file so the
        # form can't be primed with a path submit would reject anyway
        if not path or not Path(path).exists():
            return {"ok": False, "error": f"LUT not found: {path}"}
        with self._settings_lock:
            self.settings = remember_lut(path, self.settings,
                                         persist=self._persist_settings)
        return self._luts_view()

    def _clean_luts(self) -> dict:
        with self._settings_lock:
            before = len(lut_history(self.settings))
            self.settings = cleanup_lut_history(
                self.settings, persist=self._persist_settings)
        view = self._luts_view()
        view["removed"] = before - len(view["luts"])
        return view

    def _upload_lut(self, req: dict) -> dict:
        """Browser-side .cube upload: the remote-serving analog of the
        reference's add-LUT file dialog (the daemon usually isn't the
        machine with the files). Validates by parsing before saving."""
        from ..colorcore import parse_cube
        from ..colorcore.cube import CubeParseError
        from .settings import _config_root

        name = Path(str(req.get("name") or "")).name  # basename only
        if not name.endswith(".cube") or name == ".cube":
            return {"ok": False, "error": "name must be a .cube filename"}
        text = req.get("text") or ""
        try:
            lut = parse_cube(text, name)
        except CubeParseError as exc:
            return {"ok": False, "error": str(exc)}
        dest_dir = _config_root() / "luts"
        dest_dir.mkdir(parents=True, exist_ok=True)
        with self._settings_lock:
            dest = dest_dir / name
            if dest.exists() and not req.get("overwrite"):
                stem, i = dest.stem, 1  # anti-collision, like output naming
                while dest.exists():
                    dest = dest_dir / f"{stem}_{i}.cube"
                    i += 1
            dest.write_text(text)
            self.settings = remember_lut(dest, self.settings,
                                         persist=self._persist_settings)
        view = self._luts_view()
        view.update(path=str(dest), size=lut.size)
        return view

    def handle_op(self, req: dict) -> dict:
        """POST /api/op entry: app-layer ops first, everything else is the
        socket protocol verbatim."""
        op = req.get("op")
        if op == "save_preset":
            return self._save_preset(req)
        if op == "delete_preset":
            try:
                delete_preset(req.get("name", ""))
            except (PresetError, OSError, ValueError) as exc:
                return {"ok": False, "error": str(exc)}
            return {"ok": True, "presets": list_presets()}
        if op == "rename_preset":
            try:
                rename_preset(req.get("name", ""), req.get("new_name", ""))
            except (PresetError, OSError, ValueError) as exc:
                return {"ok": False, "error": str(exc)}
            return {"ok": True, "presets": list_presets()}
        if op == "luts":
            return self._luts_view()
        if op == "select_lut":
            return self._select_lut(str(req.get("path") or ""))
        if op == "clean_luts":
            return self._clean_luts()
        if op == "upload_lut":
            return self._upload_lut(req)
        if op == "ui_theme":
            return self._set_theme(str(req.get("theme") or ""))
        resp = self.queue.handle_request(req)
        if op == "submit" and resp.get("ok") and req.get("lut"):
            # Start remembers the LUT (reference main_window.py:1824)
            with self._settings_lock:
                self.settings = remember_lut(
                    req["lut"], self.settings,
                    persist=self._persist_settings)
        return resp

    def _thumb(self, task_id: str):
        from .thumbnails import ensure_thumbnail

        task = self.queue.manager.tasks.get(task_id)
        if task is None:
            return None
        path = ensure_thumbnail(task.source_path)
        if path is None or not Path(path).exists():
            return None
        return Path(path).read_bytes()

    _FILE_KINDS = ("output", "cover")

    def _file(self, task_id: str, kind: str):
        """Rendered-artifact download (the web analog of the reference's
        per-row open-output button, main_window.py row actions). Serves
        ONLY the task's own output/cover path — never an arbitrary path."""
        task = self.queue.manager.tasks.get(task_id)
        if task is None or kind not in self._FILE_KINDS:
            return None
        path = task.output_path if kind == "output" else task.cover_path
        if path is None or not Path(path).exists():
            return None
        return Path(path)

    # -- http plumbing --------------------------------------------------------
    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else 0

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def start(self) -> None:
        ui = self

        class Handler(BaseHTTPRequestHandler):
            # the daemon already logs; keep stdlib request spam off stderr
            def log_message(self, fmt, *args):  # noqa: D102
                pass

            _set_cookie: Optional[str] = None

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                if self._set_cookie:
                    self.send_header("Set-Cookie", self._set_cookie)
                    self._set_cookie = None
                self.end_headers()
                self.wfile.write(body)

            def _json(self, payload: dict, code: int = 200) -> None:
                self._send(code, json.dumps(payload).encode("utf-8"),
                           "application/json")

            # -- trust checks (module docstring: the HTTP port is reachable
            # from any page the browser visits, unlike the Unix socket) ----
            def _host_ok(self) -> bool:
                if not _is_loopback(ui.host):
                    return True  # non-loopback binds are token-gated instead
                return _is_loopback(_host_name(self.headers.get("Host")
                                               or ""))

            def _cookie_token(self) -> str:
                for part in (self.headers.get("Cookie") or "").split(";"):
                    name, _, value = part.strip().partition("=")
                    if name == "luttok":
                        return value
                return ""

            def _authed(self, q) -> bool:
                if ui.token is None:
                    return True
                import hmac

                presented = (self.headers.get("X-Auth-Token")
                             or self._cookie_token()
                             or q.get("token", [""])[0])
                # constant-time: the port may be network-reachable
                ok = hmac.compare_digest(presented, ui.token)
                if ok and q.get("token", [""])[0] == ui.token:
                    # first visit via ?token=...: persist it so the page's
                    # fetches and plain <a> download links ride along
                    self._set_cookie = ("luttok=" + ui.token
                                        + "; Path=/; HttpOnly; "
                                          "SameSite=Strict")
                return ok

            def _gate(self, q) -> bool:
                """Host + token gate for every endpoint; replies on fail."""
                if not self._host_ok():
                    self._json({"ok": False,
                                "error": "Host header does not match the "
                                         "bound address"}, 403)
                    return False
                if not self._authed(q):
                    self._json({"ok": False,
                                "error": "missing or wrong token (open "
                                         "/?token=... or send "
                                         "X-Auth-Token)"}, 401)
                    return False
                return True

            def _serve_file(self, path) -> None:
                """Stream a rendered artifact. Once the body has started,
                errors close the connection instead of appending a JSON 500
                onto declared-length framing (which would silently truncate
                the download into a corrupt file)."""
                import mimetypes
                import shutil

                ctype = (mimetypes.guess_type(path.name)[0]
                         or "application/octet-stream")
                size = path.stat().st_size
                f = path.open("rb")
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    fname = path.name.replace("\\", "_").replace('"', "_")
                    self.send_header("Content-Disposition",
                                     f'attachment; filename="{fname}"')
                    self.send_header("Content-Length", str(size))
                    self.end_headers()
                    # stream: finished masters/outputs can be GBs
                    try:
                        shutil.copyfileobj(f, self.wfile, 1 << 20)
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # client went away mid-download
                    except Exception:
                        self.close_connection = True
                finally:
                    f.close()

            def do_GET(self):  # noqa: N802
                url = urlparse(self.path)
                q = parse_qs(url.query)
                try:
                    if not self._gate(q):
                        return
                    if url.path == "/":
                        self._send(200, PAGE.encode("utf-8"),
                                   "text/html; charset=utf-8")
                    elif url.path == "/api/meta":
                        self._json(ui._meta())
                    elif url.path == "/api/queue":
                        self._json(ui.queue.handle_request({"op": "status"}))
                    elif url.path == "/api/task":
                        self._json(ui.queue.handle_request(
                            {"op": "status",
                             "task_id": q.get("id", [""])[0]}))
                    elif url.path == "/api/preset":
                        self._json(ui._load_preset(q.get("name", [""])[0]))
                    elif url.path == "/api/thumb":
                        data = ui._thumb(q.get("task", [""])[0])
                        if data is None:
                            self._json({"ok": False,
                                        "error": "no thumbnail"}, 404)
                        else:
                            self._send(200, data, "image/jpeg")
                    elif url.path == "/api/file":
                        path = ui._file(q.get("task", [""])[0],
                                        q.get("kind", ["output"])[0])
                        if path is None:
                            self._json({"ok": False,
                                        "error": "no such artifact"}, 404)
                        else:
                            self._serve_file(path)
                    else:
                        self._json({"ok": False, "error": "not found"}, 404)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-response (e.g. download)
                except Exception as exc:  # never kill the connection
                    try:
                        self._json({"ok": False, "error": str(exc)[:300]},
                                   500)
                    except OSError:
                        pass

            def do_POST(self):  # noqa: N802
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if not self._gate(q):
                    return
                if url.path != "/api/op":
                    self._json({"ok": False, "error": "not found"}, 404)
                    return
                ctype = (self.headers.get("Content-Type") or "").lower()
                if "application/json" not in ctype:
                    # a browser cannot send this header cross-origin without
                    # a CORS preflight (never answered) — CSRF stop #1
                    self._json({"ok": False,
                                "error": "Content-Type must be "
                                         "application/json"}, 415)
                    return
                origin = self.headers.get("Origin")
                if origin:  # CSRF stop #2: explicit cross-origin posts
                    ohost = urlparse(origin).hostname or ""
                    # same-origin = the host the client actually reached
                    # (its Host header), NOT the bind address — binding
                    # 0.0.0.0 or browsing a LAN bind by hostname must not
                    # 403 the page's own fetches
                    reached = _host_name(self.headers.get("Host") or "")
                    if not (_is_loopback(ohost)
                            or (ohost and ohost == reached)):
                        self._json({"ok": False,
                                    "error": "cross-origin requests are "
                                             "not accepted"}, 403)
                        return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    if length < 0:
                        raise ValueError("negative Content-Length")
                    if length > _MAX_BODY:
                        self._json({"ok": False,
                                    "error": "request too large"}, 413)
                        return
                    raw = self.rfile.read(length)
                    req = json.loads(raw.decode("utf-8"))
                    if not isinstance(req, dict):
                        raise ValueError("request body must be an object")
                except (ValueError, UnicodeDecodeError) as exc:
                    self._json({"ok": False, "error": f"bad json: {exc}"},
                               400)
                    return
                try:
                    resp = ui.handle_op(req)
                    then_shutdown = (isinstance(resp, dict)
                                     and resp.pop("_then_shutdown", False))
                    self._json(resp)
                    if then_shutdown:
                        # reply flushed: signal shutdown race-free (the
                        # socket-transport twin does the same)
                        self.wfile.flush()
                        ui.queue.finalize_shutdown()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-response
                except Exception as exc:  # never kill the connection
                    try:
                        self._json({"ok": False, "error": str(exc)[:300]},
                                   500)
                    except OSError:
                        pass

        srv = ThreadingHTTPServer((self.host, self._requested_port), Handler)
        srv.daemon_threads = True
        self._server = srv
        self._thread = threading.Thread(target=srv.serve_forever,
                                        name="lut-torch-webui", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        srv, self._server = self._server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
