"""The web GUI page (single file, zero external assets).

Served at GET / by app/webui.py. Mirrors the reference main window's layout:
parameters panel on the left (every ProcessingParams field, blank = auto,
per-field inline help — reference main_window.py:450-903 and 1269-1622),
live queue table with thumbnails/progress/cancel/reprocess/info on the
right (main_window.py:2188-2271), aggregate progress in the header
(main_window.py:331-371). Theme echoes qt-material dark_teal (app.py:77-81).
"""

PAGE = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>LUT Renderer — TPU</title>
<style>
:root { --bg:#121517; --panel:#1b2023; --panel2:#22282c; --line:#2e373c;
        --text:#e0e3e5; --dim:#93a1a8; --teal:#26a69a; --teal2:#1d7d74;
        --red:#ef5350; --amber:#ffb74d; --green:#66bb6a; }
body.light { --bg:#eceff1; --panel:#ffffff; --panel2:#eef2f4;
             --line:#cfd8dc; --text:#263238; --dim:#546e7a;
             --teal:#00897b; --teal2:#26a69a; }
* { box-sizing:border-box; }
body { margin:0; background:var(--bg); color:var(--text);
       font:14px/1.45 system-ui,-apple-system,"Segoe UI",sans-serif; }
header { display:flex; align-items:center; gap:16px; padding:10px 18px;
         background:var(--panel); border-bottom:1px solid var(--line);
         position:sticky; top:0; z-index:5; }
header h1 { font-size:17px; margin:0; font-weight:600; letter-spacing:.3px; }
header h1 .tpu { color:var(--teal); }
header .ver { color:var(--dim); font-size:12px; }
#agg { flex:1; display:flex; align-items:center; gap:8px; min-width:160px; }
.bar { flex:1; height:8px; background:var(--panel2); border-radius:4px;
       overflow:hidden; }
.bar > div { height:100%; width:0%; background:var(--teal);
             transition:width .3s; }
button { background:var(--panel2); color:var(--text);
         border:1px solid var(--line); border-radius:4px; padding:5px 12px;
         cursor:pointer; font:inherit; }
button:hover { border-color:var(--teal); }
button.primary { background:var(--teal); border-color:var(--teal);
                 color:#06211e; font-weight:600; }
button.danger:hover { border-color:var(--red); color:var(--red); }
.conc { display:flex; align-items:center; gap:6px; color:var(--dim);
        font-size:12px; }
.conc input { width:56px; background:var(--panel2); color:var(--text);
  border:1px solid var(--line); border-radius:4px; padding:4px 6px; }
a.dl { color:var(--teal); font-size:12px; text-decoration:none;
       border:1px solid var(--line); border-radius:4px; padding:4px 8px;
       display:inline-block; }
a.dl:hover { border-color:var(--teal); }
main { display:grid; grid-template-columns:minmax(330px,430px) 1fr;
       gap:14px; padding:14px 18px; align-items:start; }
section { background:var(--panel); border:1px solid var(--line);
          border-radius:8px; padding:14px 16px; }
h2 { font-size:13px; margin:2px 0 10px; text-transform:uppercase;
     letter-spacing:.8px; color:var(--teal); }
h2 .hint { color:var(--dim); text-transform:none; letter-spacing:0;
           font-weight:400; margin-left:6px; }
label { display:block; color:var(--dim); font-size:12px; margin:8px 0 2px; }
input[type=text], textarea, select {
  width:100%; background:var(--panel2); color:var(--text);
  border:1px solid var(--line); border-radius:4px; padding:6px 8px;
  font:inherit; }
input:focus, textarea:focus, select:focus { outline:none;
  border-color:var(--teal); }
textarea { min-height:64px; resize:vertical; font-family:ui-monospace,
  Menlo,Consolas,monospace; font-size:12px; }
.row { display:flex; gap:10px; align-items:end; }
.row > * { flex:1; }
.row > button { flex:0 0 auto; }
#params { display:grid; grid-template-columns:1fr 1fr; gap:2px 14px;
          margin-bottom:10px; }
.field { display:flex; align-items:center; gap:6px; padding:2px 0; }
.field label { flex:1; margin:0; font-size:12px; }
.field input[type=text] { flex:1.2; width:auto; padding:3px 6px;
  font-size:12px; }
.field input[type=checkbox] { accent-color:var(--teal); }
.field .help { flex:0 0 auto; padding:0 7px; font-size:11px;
  color:var(--dim); border-radius:50%; }
pre { background:var(--panel2); border:1px solid var(--line);
      border-radius:4px; padding:8px 10px; white-space:pre-wrap;
      font:12px ui-monospace,Menlo,Consolas,monospace; max-height:260px;
      overflow:auto; }
#helpbox { border-color:var(--teal2); }
table { width:100%; border-collapse:collapse; }
th { text-align:left; color:var(--dim); font-size:11px;
     text-transform:uppercase; letter-spacing:.6px; padding:4px 8px;
     border-bottom:1px solid var(--line); }
td { padding:6px 8px; border-bottom:1px solid var(--line);
     vertical-align:middle; }
td img { width:64px; border-radius:3px; display:block; }
.chip { display:inline-block; padding:1px 9px; border-radius:10px;
        font-size:11px; font-weight:600; }
.chip.pending   { background:#37474f; color:#cfd8dc; }
.chip.running   { background:var(--teal2); color:#e0f2f1; }
.chip.completed { background:#2e7d32; color:#e8f5e9; }
.chip.failed    { background:#c62828; color:#ffebee; }
.chip.canceled  { background:#a67126; color:#fff3e0; }
td .bar { width:120px; }
.name { max-width:260px; overflow:hidden; text-overflow:ellipsis;
        white-space:nowrap; }
.err { color:var(--red); font-size:12px; }
.empty { color:var(--dim); padding:18px 8px; }
.overlay { position:fixed; inset:0; background:rgba(0,0,0,.6); display:flex;
           align-items:center; justify-content:center; z-index:20; }
.overlay .card { background:var(--panel); border:1px solid var(--teal2);
                 border-radius:8px; padding:14px 16px;
                 width:min(720px,90vw); max-height:85vh; overflow:auto; }
.overlay pre { max-height:50vh; }
.lutrow { display:flex; align-items:center; gap:10px; padding:5px 2px;
          border-bottom:1px solid var(--line); font-size:12px; }
.lutrow .lpath { flex:1; overflow:hidden; text-overflow:ellipsis;
                 white-space:nowrap; font-family:ui-monospace,Menlo,
                 Consolas,monospace; }
.lutrow .ok { color:var(--green); }
.lutrow .missing { color:var(--red); }
input[type=file] { color:var(--dim); font-size:12px; width:100%; }
[hidden] { display:none !important; }
</style>
</head>
<body class="light">
<header>
  <h1>LUT Renderer <span class="tpu">TPU</span></h1>
  <span class="ver" id="ver"></span>
  <div id="agg"><div class="bar"><div id="aggfill"></div></div>
    <span id="aggpct" class="ver">0%</span></div>
  <label class="conc">concurrency
    <input type="number" id="conc" min="1" max="16" value="1"></label>
  <button id="theme" title="dark/light">◐</button>
  <button id="clear">Clear completed</button>
  <button id="shutdown" class="danger">Shutdown</button>
</header>
<main>
<section id="addpanel">
  <h2>Add tasks</h2>
  <label>Source files — server paths, one per line
    <textarea id="files" placeholder="/data/clips/a.mp4"></textarea></label>
  <label>LUT (.cube) — picks from history</label>
  <div class="row">
    <div><input type="text" id="lut" list="lutlist" placeholder="none">
      <datalist id="lutlist"></datalist></div>
    <button id="lutmanage" type="button">Manage</button>
  </div>
  <div class="row">
    <div><label>Output dir (blank = &lt;src&gt;/output)
      <input type="text" id="outdir"></label></div>
    <div><label>Master dir (pro mode)
      <input type="text" id="masterdir"></label></div>
  </div>
  <div class="row">
    <div><label>Mode template
      <select id="mode"><option>fast</option><option>pro</option></select>
    </label></div>
    <div><label>Preset <select id="preset"></select></label></div>
    <button id="loadpreset">Load</button>
    <button id="delpreset" class="danger">Delete</button>
  </div>
  <div class="row">
    <div><label>Save current parameters as
      <input type="text" id="presetname" placeholder="preset name"></label>
    </div>
    <button id="savepreset">Save</button>
  </div>
  <h2>Parameters <span class="hint">blank = auto · ? = help</span></h2>
  <div id="params"></div>
  <button id="submit" class="primary">Add &amp; start</button>
  <pre id="notices" hidden></pre>
  <pre id="helpbox" hidden></pre>
</section>
<section id="queuepanel">
  <h2>Queue</h2>
  <table>
    <thead><tr><th></th><th>Task</th><th>Status</th><th>Progress</th>
      <th></th></tr></thead>
    <tbody id="queue"><tr><td colspan="5" class="empty">no tasks yet
      </td></tr></tbody>
  </table>
</section>
</main>
<div id="modal" class="overlay" hidden><div class="card">
  <div class="row"><h2 id="modaltitle" style="flex:1">Task</h2>
    <button id="modalclose">close</button></div>
  <pre id="modalbody"></pre>
</div></div>
<div id="lutsmodal" class="overlay" hidden><div class="card">
  <div class="row"><h2 style="flex:1">LUT library</h2>
    <button id="lutsclose">close</button></div>
  <div class="row">
    <div><input type="file" id="lutfile" accept=".cube"></div>
    <button id="lutupload">Upload</button>
    <button id="lutclean">Clean invalid</button>
  </div>
  <input type="text" id="lutfilter" placeholder="filter…"
         style="margin:8px 0 4px">
  <div id="lutslist"></div>
</div></div>
<script>
"use strict";
const $ = id => document.getElementById(id);
let META = null, lastQueueJson = "";

async function api(path) { return (await fetch(path)).json(); }
async function op(req) {
  const r = await fetch("/api/op", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify(req)});
  return r.json();
}
function note(msg, isErr) {
  const n = $("notices"); n.hidden = !msg; n.textContent = msg || "";
  n.style.borderColor = isErr ? "var(--red)" : "var(--line)";
}

function buildForm() {
  const grid = $("params"); grid.innerHTML = "";
  for (const f of META.fields) {
    const row = document.createElement("div"); row.className = "field";
    const lab = document.createElement("label"); lab.textContent = f.name;
    lab.htmlFor = "p_" + f.name;
    const input = document.createElement("input");
    if (f.bool) input.type = "checkbox";
    else { input.type = "text"; input.placeholder = "auto"; }
    input.id = "p_" + f.name;
    const help = document.createElement("button");
    help.textContent = "?"; help.className = "help"; help.type = "button";
    help.onclick = () => { const hb = $("helpbox");
      hb.textContent = f.help || ("(no help topic for " + f.name + ")");
      hb.hidden = false; };
    row.append(lab, input, help); grid.append(row);
  }
  applyTemplate($("mode").value);
}
function setParams(values) {
  for (const f of META.fields) {
    const el = $("p_" + f.name); if (!el) continue;
    const v = values[f.name];
    if (f.bool) el.checked = !!v;
    else el.value = v == null ? "" : String(v);
  }
}
function applyTemplate(mode) {
  const vals = {};
  for (const f of META.fields) vals[f.name] = mode === "pro" ? f.pro : f.fast;
  setParams(vals);
}
function collectParams() {
  const out = {};
  for (const f of META.fields) {
    const el = $("p_" + f.name);
    out[f.name] = f.bool ? el.checked : el.value;
  }
  return out;
}
function fillMeta(m) {
  META = m;
  $("ver").textContent = "v" + m.version;
  $("conc").value = m.concurrency;
  document.body.classList.toggle("light", m.ui_theme === "light");
  $("lutlist").innerHTML = m.luts.map(l =>
    `<option value="${esc(l)}">`).join("");
  const sel = $("preset");
  sel.innerHTML = "<option value=''>—</option>" + m.presets.map(p =>
    `<option>${esc(p)}</option>`).join("");
  if (!$("lut").value && m.last_lut) $("lut").value = m.last_lut;
}

async function refreshMeta() { fillMeta(await api("/api/meta")); }

function esc(s) {
  return String(s).replaceAll("&", "&amp;").replaceAll("<", "&lt;")
    .replaceAll(">", "&gt;").replaceAll('"', "&quot;")
    .replaceAll("'", "&#39;");
}
function chip(status) { return `<span class="chip ${status}">${status}</span>`; }
function row(t) {
  const running = t.status === "pending" || t.status === "running";
  let btns = running
    ? `<button data-act="cancel" data-id="${t.task_id}">Cancel</button>`
    : `<button data-act="reprocess" data-id="${t.task_id}">Reprocess</button>`;
  if (t.status === "completed")
    btns += ` <a class="dl" href="/api/file?task=${t.task_id}"
               download>Output</a>`;
  const err = t.error
    ? '<div class="err">' + esc(t.error) + '</div>' : "";
  return `<tr>
    <td><img src="/api/thumb?task=${t.task_id}" alt=""
         onerror="this.style.display='none'"></td>
    <td><div class="name" title="${esc(t.source)}">${esc(t.name)}</div>
        ${err}</td>
    <td>${chip(t.status)}</td>
    <td><div class="bar"><div style="width:${t.progress}%"></div></div>
        ${t.progress}%</td>
    <td>${btns}
        <button data-act="info" data-id="${t.task_id}">Info</button></td>
  </tr>`;
}
let hadUnfinished = false;
async function pollQueue() {
  try {
    const q = await api("/api/queue");
    if (!q.ok) return;
    const unfinished = q.tasks.some(t =>
      t.status === "pending" || t.status === "running");
    if (hadUnfinished && !unfinished && q.tasks.length)
      note("queue finished — all tasks done");  // the tray-toast analog
    hadUnfinished = unfinished;
    const json = JSON.stringify(q);
    if (json === lastQueueJson) return;
    lastQueueJson = json;
    $("aggfill").style.width = q.queue_progress + "%";
    $("aggpct").textContent = q.queue_progress + "%";
    $("queue").innerHTML = q.tasks.length
      ? q.tasks.map(row).join("")
      : `<tr><td colspan="5" class="empty">no tasks yet</td></tr>`;
  } catch (e) { /* daemon restarting; keep polling */ }
}

async function showInfo(id) {
  const r = await api("/api/task?id=" + encodeURIComponent(id));
  if (!r.ok) { note(r.error, true); return; }
  const t = r.task;
  $("modaltitle").textContent = t.name + " — " + t.status;
  let probe = "";
  if (t.source_info) {
    const rows = Object.entries(t.source_info).map(
      ([k, v]) => k + ": " + JSON.stringify(v));
    probe = "\n--- source probe ---\n" + rows.join("\n") + "\n";
  }
  $("modalbody").textContent =
    `source:   ${t.source}\noutput:   ${t.output}\n` +
    `status:   ${t.status} (${t.progress}%)\n` +
    (t.error ? `error:    ${t.error}\n` : "") + probe +
    `\n--- runtime log ---\n` + (t.logs || []).join("\n");
  $("modal").hidden = false;
}

$("queue").addEventListener("click", async ev => {
  const b = ev.target.closest("button"); if (!b) return;
  const id = b.dataset.id, act = b.dataset.act;
  if (act === "info") return showInfo(id);
  const r = await op({op: act, task_id: id});
  if (!r.ok) note(r.error, true);
  lastQueueJson = ""; pollQueue();
});
$("modalclose").onclick = () => { $("modal").hidden = true; };
$("mode").onchange = () => applyTemplate($("mode").value);
$("loadpreset").onclick = async () => {
  const name = $("preset").value; if (!name) return;
  const r = await api("/api/preset?name=" + encodeURIComponent(name));
  if (r.ok) { setParams(r.params); note("preset '" + name + "' loaded"); }
  else note(r.error, true);
};
$("delpreset").onclick = async () => {
  const name = $("preset").value; if (!name) return;
  if (!confirm("Delete preset " + name + "?")) return;
  const r = await op({op: "delete_preset", name});
  if (r.ok) { note("preset " + name + " deleted"); refreshMeta(); }
  else note(r.error, true);
};
$("savepreset").onclick = async () => {
  const name = $("presetname").value.trim();
  if (!name) { note("give the preset a name first", true); return; }
  let r = await op({op: "save_preset", name, params: collectParams()});
  if (!r.ok && r.error === "exists") {
    if (!confirm(`Preset '${name}' exists — overwrite?`)) return;
    r = await op({op: "save_preset", name, params: collectParams(),
                  overwrite: true});
  }
  if (r.ok) { note("preset '" + name + "' saved"); refreshMeta(); }
  else note(r.error, true);
};
$("submit").onclick = async () => {
  const files = $("files").value.split("\n").map(s => s.trim())
    .filter(Boolean);
  if (!files.length) { note("list at least one source file", true); return; }
  const req = {op: "submit", files, params: collectParams()};
  if ($("lut").value.trim()) req.lut = $("lut").value.trim();
  if ($("outdir").value.trim()) req.out_dir = $("outdir").value.trim();
  if ($("masterdir").value.trim()) req.master_dir = $("masterdir").value.trim();
  const r = await op(req);
  if (r.ok) {
    note([`${r.task_ids.length} task(s) queued`,
          ...(r.logs || []), ...(r.warnings || [])].join("\n"));
    refreshMeta();  // LUT history may have gained an entry
  } else note(r.error, true);
  lastQueueJson = ""; pollQueue();
};
$("clear").onclick = async () => {
  const r = await op({op: "clear"});
  if (r.ok) note(`removed ${r.removed} finished task(s)`);
  lastQueueJson = ""; pollQueue();
};
let LUTS = [];
function renderLuts() {
  const needle = $("lutfilter").value.trim().toLowerCase();
  const shown = LUTS.filter(l =>
    !needle || l.path.toLowerCase().includes(needle));
  $("lutslist").innerHTML = shown.map(l => {
    const mark = l.exists ? "ok" : "missing";
    const glyph = l.exists ? "✓" : "✗";
    const p = esc(l.path);
    return `<div class="lutrow"><span class="${mark}">${glyph}</span>` +
           `<span class="lpath">${p}</span>` +
           `<button data-use="${p}">Use</button></div>`;
  }).join("") || '<div class="empty">' +
    (LUTS.length ? "no match" : "history is empty") + '</div>';
}
async function refreshLuts() {
  const r = await op({op: "luts"});
  if (!r.ok) { note(r.error, true); return; }
  LUTS = r.luts;
  renderLuts();
}
$("lutfilter").oninput = renderLuts;
$("lutmanage").onclick = () => { $("lutsmodal").hidden = false;
                                 refreshLuts(); };
$("lutsclose").onclick = () => { $("lutsmodal").hidden = true; };
$("lutslist").addEventListener("click", async ev => {
  const b = ev.target.closest("button"); if (!b) return;
  const r = await op({op: "select_lut", path: b.dataset.use});
  if (r.ok) { $("lut").value = b.dataset.use; $("lutsmodal").hidden = true;
              note("LUT selected"); refreshMeta(); }
  else note(r.error, true);
});
$("lutclean").onclick = async () => {
  const r = await op({op: "clean_luts"});
  if (r.ok) { note("removed " + r.removed + " stale history entries");
              refreshLuts(); refreshMeta(); }
  else note(r.error, true);
};
$("lutupload").onclick = async () => {
  const f = $("lutfile").files[0];
  if (!f) { note("choose a .cube file first", true); return; }
  const text = await f.text();
  const r = await op({op: "upload_lut", name: f.name, text});
  if (r.ok) { $("lut").value = r.path;
              note("uploaded " + r.path + " (" + r.size + "³)");
              refreshLuts(); refreshMeta(); }
  else note(r.error, true);
};
$("theme").onclick = async () => {
  const next = document.body.classList.contains("light") ? "dark" : "light";
  const r = await op({op: "ui_theme", theme: next});
  if (r.ok) document.body.classList.toggle("light", next === "light");
  else note(r.error, true);
};
$("conc").onchange = async () => {
  const r = await op({op: "config",
                      concurrency: parseInt($("conc").value, 10) || 1});
  if (r.ok) { $("conc").value = r.concurrency;
              note("concurrency set to " + r.concurrency); }
  else note(r.error, true);
};
$("shutdown").onclick = async () => {
  if (!confirm("Shut down the render daemon?")) return;
  await op({op: "shutdown"});
  note("daemon shutting down — running tasks cancel");
};

refreshMeta().then(buildForm);
pollQueue();
setInterval(pollQueue, 1000);
</script>
</body>
</html>
"""
