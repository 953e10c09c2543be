"""Per-parameter help topics — the reference ships a rich per-field help
popup system (~350 lines, main_window.py:1269-1622, in Chinese); this is the
headless analog in English: `lut-tpu help [topic]`.

Content mirrors the reference's guidance where a policy consequence exists
(what each knob does, what "blank = auto" means, interactions like
copy-codec + LUT) and adds TPU-build specifics (precision tiers, dither
substitutions, encoder availability).
"""

from __future__ import annotations

from typing import Dict

TOPICS: Dict[str, str] = {
    "mode": """\
--mode fast|pro
  fast: one encode pass — decode, LUT on the TPU, distribution encode.
  pro:  two-stage mastering — stage 1 renders the LUT into a ProRes 422 HQ
        master (yuv422p10le, audio copied) in --master-dir; stage 2 encodes
        the distribution file from that master with YOUR parameters and no
        LUT. The master is re-probed so stage-2 policy sees its real
        properties, and it is deleted after success (also after failure —
        an improvement over the reference, which leaks it).
  Pro mode requires --master-dir and warns when the estimated ProRes size
  (220 Mbps at 1080p30, scaled by w*h*fps) crowds the free disk space.""",
    "codec": """\
--codec NAME | copy
  Video encoder for the (final) encode stage. Bundled encoders here:
  prores_ks (the pro-master codec), prores, prores_aw, mpeg4, libvpx-vp9,
  libvpx (VP8), dnxhd (DNxHR profiles; no profile -> dnxhr_hq, 10-bit ->
  dnxhr_hqx automatically), cfhd (CineForm, 10-bit), v210 (uncompressed
  10-bit 4:2:2), mpeg2video, utvideo, ffv1, mjpeg, png. libx264/libx265
  are NOT in the bundled libraries; like the reference, no preflight
  hides that — the task fails with a clear error if you request one.
  copy: stream-copies video. A LUT cannot be applied to a copied stream;
  task creation auto-switches to an encoding codec (the reference's
  copy-codec guard) or `plan` raises if forced.

  Throughput steering (encode runs on the HOST; the TPU renders 4K at
  50-220 fps, so a slow encoder IS the pipeline bound — measured on one
  core, experiments/r8_codec_throughput.py):
    mpeg4 ~113 fps 1080p / 23 fps 4K and mjpeg ~100/40 are the
    throughput-cheap lossy picks for serving; utvideo (~39/7) and ffv1
    (~13/4.5) when lossless matters; libvpx-vp9 (~3.5/0.9 at CRF) and
    prores_ks (~1.9/0.6 — the bundled build is single-threaded) are
    quality-bound offline choices.""",
    "pix_fmt": """\
--pix-fmt FMT (blank = policy decides)
  Output pixel format. The bit-depth policy fills this when blank:
  preserve/auto + 10-bit source + 10-bit-capable codec -> yuv422p10le for
  prores_ks/cfhd/v210/dnxhd, yuv420p10le otherwise; force_8bit ->
  yuv420p. If the chosen
  encoder cannot take the format, the engine negotiates the closest
  supported one and logs the change.""",
    "bit_depth": """\
--bit-depth preserve|auto|force_8bit
  preserve/auto: keep 10-bit sources at 10 bit when the encoder can take
  it, else fall to 8 bit (with a note). force_8bit: always yuv420p — pair
  with --dither to mask banding from the depth reduction.""",
    "resolution": """\
--resolution WxH (blank = source)
  Output size. Blank inherits the probed source resolution (the
  reference's smart default). Scaling matches swscale's default bicubic
  (B=0, C=0.6 — what FFmpeg `-s` does), run on the TPU in RGB after the
  LUT as MXU matmuls.""",
    "bitrate": """\
--bitrate N[k|M] (blank = source)
  Target video bitrate. Blank inherits the source's probed bitrate. When
  set, the policy also pins maxrate = bitrate and bufsize = 2x bitrate
  (the reference's stabilization rule) so rate spikes stay bounded.""",
    "crf": """\
--crf N (x264 scale; lower = higher quality, bigger file)
  Constant-quality knob: the encoder raises the rate on complex frames and
  lowers it on simple ones, keeping perceived quality stable. Typical
  x264 practice is 18-23. Usually set EITHER crf OR bitrate, not both.
  Per-codec mechanism here: libvpx-vp9 honors its native crf option
  (0-63 scale, clamped; with no bitrate set the encoder runs b=0
  constant-quality, with one it runs constrained quality). Codecs without
  native CRF (mpeg4, mjpeg) get a constant quantizer via x264's rate
  model: qscale = 4 * 2^((crf - 23) / 6) — bitrate halves per +6 CRF,
  anchored at CRF 23 ~ q4. Either way the task log notes the mechanism.""",
    "lut": """\
--lut FILE.cube
  The 3D look-up table mapping input colors to output colors — color-space
  or gamma conversion (Log -> Rec.709) and creative grades. A matching
  conversion LUT gets log footage to a deliverable look quickly; a
  mismatched one causes casts, broken skin tones, crushed/clipped detail.
  Troubleshooting: washed-out output usually means a missing Log->709
  conversion; oversaturated/over-contrasty output usually means the
  conversion was applied twice or the LUT doesn't match the source.
  Applied on the TPU by the Pallas MXU kernel (the engine's lut3d).""",
    "preset": """\
--enc-preset NAME
  Speed/efficiency trade for encoders that support it (ultrafast ...
  veryslow on the x264 family). Slower presets analyze harder and shrink
  files at equal quality; they never change resolution or frame rate.
  Bundled encoders here mostly ignore it (ProRes/FFV1/mpeg4 have no
  preset ladder; libvpx-vp9 uses deadline/cpu-used internally); the value
  is plumbed through like the reference passes -preset, and encoders that
  don't know it simply skip it.""",
    "tune": """\
--tune NAME
  Content-specific tuning for encoders that support it (x264: film,
  animation, grain, stillimage, fastdecode, zerolatency). Plumbed through
  like the reference; the bundled encoder set has no tune-aware codec, so
  it is a no-op here unless such an encoder is present at run time.""",
    "profile": """\
--enc-profile NAME
  Codec profile: capability envelope vs compatibility. H.264: baseline
  (max compatibility, fewest features) / main / high. ProRes (prores_ks):
  numeric profile 0-5 = proxy/LT/standard/HQ (pro masters use 3 = 422 HQ)
  /4444/4444XQ. Leave blank to let the encoder pick.""",
    "level": """\
--level N
  Codec level: caps stream complexity (max resolution/fps/bitrate/
  reference frames) so target hardware decoders are guaranteed to cope.
  Too high: old devices refuse to hardware-decode. Too low: the encoder
  must degrade quality or error out. Leave blank (auto) unless a delivery
  spec names one (e.g. H.264 4.1/5.1).""",
    "threads": """\
--threads N (blank = auto)
  Encoder thread count. The ffmpeg binary auto-threads encoders; a raw
  libavcodec context does not — this engine passes threads=auto by
  default to match the reference's effective behavior. Set a number to
  bound encoder CPU use (e.g. while editing alongside a batch). Note the
  TPU render stage is unaffected; threads only shapes the host encode.""",
    "audio_bitrate": """\
--audio-bitrate N[k] (blank = encoder default)
  Target audio bitrate for transcoded audio (aac). Higher keeps more
  detail, lower risks high-frequency loss and compression artifacts.
  128k is fine for speech/general video, 192k+ for music. Ignored when
  the audio codec is copy.""",
    "sample_rate": """\
--sample-rate N (blank = source)
  Audio sample rate; 48000 is the video-industry standard, 44100 the
  CD/music one. Changing it forces a resample — leave blank to keep the
  source rate and avoid one. Ignored with audio copy.""",
    "channels": """\
--channels N (blank = source)
  Output channel count. 2 (stereo) is the most compatible for web/mobile;
  keeping a multichannel source preserves spatial audio for home-theater
  delivery. Changing the count triggers a downmix/upmix, which can shift
  loudness. Ignored with audio copy.""",
    "faststart": """\
--faststart
  Moves the MP4/MOV index (moov atom) to the file head so playback can
  start before the download finishes — the thing to enable for web/cloud
  preview delivery. No quality impact; the muxer rewrites the container
  once at the end. No effect on non-MP4-family containers.""",
    "overwrite": """\
overwrite behavior
  Output naming never clobbers existing files: collisions get _1, _2...
  suffixes, and only the exact resolved output path is overwritten when a
  task re-runs (the reference's -y applies the same way). There is no
  flag to disable this; reprocessing a task picks a fresh name.""",
    "cover": """\
--cover
  Saves the output's first decodable frame as stem_cover.jpg next to the
  output — a poster/preview image for file managers and media libraries.
  Adds one tiny extraction pass after the encode; the video itself is
  untouched. If your first frame is a slate/black, trim first or grab a
  better frame manually.""",
    "inherit_metadata": """\
--no-inherit-metadata
  Color metadata (primaries, transfer, matrix, range) tells players how
  to interpret pixels. By default the policy inherits the source's tags
  when no LUT forces bt709 tagging — keeping cross-player appearance
  stable. Disabling it leaves outputs untagged unless the LUT tag policy
  writes them. Remember tags are labels, not conversions: a Log source
  still needs a conversion LUT regardless of tagging.""",
    "force_cfr": """\
--no-force-cfr
  VFR (variable frame rate — phones, screen recordings) breaks timeline
  sync in many NLEs, so VFR sources are forced to constant frame rate at
  the source rate by default (duplicate/drop against target timestamps,
  the reference's rule). CFR sources pass through untouched. Disable only
  if you must preserve original timestamps and your downstream tools
  handle VFR.""",
    "master_dir": """\
--master-dir DIR (pro mode)
  Where stage 1 writes the intermediate ProRes 422 HQ master. Pro mode
  refuses to start without it (the reference behaves the same). Pick a
  roomy local disk: the estimator plans 220 Mbps at 1080p30 scaled by
  w*h*fps and warns when the total crowds free space. Masters are
  deleted after success AND after failure/cancel (improvement over the
  reference, which can leak them).""",
    "out_dir": """\
--out-dir DIR (blank = <source>/output)
  Destination for outputs. Blank uses an output/ folder beside each
  source (created on demand), the reference's default. Batch jobs onto a
  partition with room; keep projects in separate directories for easy
  archiving.""",
    "hardware": """\
TPU hardware notes
  The pixel path (YUV<->RGB, range, chroma resampling, 3D-LUT, dither,
  quantization) runs fused on the TPU; decode/encode run on the host via
  the bundled FFmpeg libraries. One chip time-slices between concurrent
  tasks; multi-chip pods shard frames across chips over ICI (batch axis)
  with the LUT replicated — no cross-chip traffic per frame. First use of
  a new (shape, LUT-size, tier) combination compiles a program (seconds
  to ~a minute); compiled programs land in a persistent cache, so warm
  runs start instantly.""",
    "fps": """\
--fps N (blank = passthrough) / --no-force-cfr
  Setting fps forces constant frame rate at that rate (duplicate/drop on
  decoded timestamps). Blank: VFR sources are still forced to CFR at the
  source rate unless --no-force-cfr (VFR breaks many NLEs; the reference
  defaults the same way). GOP defaults to round(fps) when unset.""",
    "gop": """\
--gop N (blank = auto)
  Keyframe (I-frame) interval. Longer GOPs compress better but make
  scrubbing/edit-point seeking coarser; shorter GOPs are edit-friendly
  but bigger. Blank: round(fps) — about one keyframe per second, the
  reference's rule (a conservative, NLE-friendly default; distribution
  encodes often stretch to 2x fps).""",
    "interp": """\
--interp tetrahedral|trilinear|nearest|pyramid|prism
  3D-LUT interpolation. tetrahedral (default) matches FFmpeg lut3d's
  default and is the grading-industry standard; trilinear is faster;
  nearest/pyramid/prism complete FFmpeg's mode set ('cubic' falls back to
  tetrahedral, as FFmpeg itself rejects it). All five run natively on the
  TPU with max dE76 vs FFmpeg lut3d ~ 1e-4 at exact precision.""",
    "precision": """\
kernel precision (automatic)
  The LUT kernel carries several numeric tiers (int8 table pair at the
  MXU's 2x int8 rate, bf16-pair "exact", bf16-single "fast", and a merged
  coarse+residual decomposition for 65^3 LUTs). Interpolation weights are
  exact f32 in every tier (they apply after the dot), so the production
  int8 tier is itself near-exact (~3e-4 dE76 vs FFmpeg lut3d). Selection
  is still automatic per LUT: a NumPy replay of each tier's numerics over
  a dense probe set must clear a 0.4 dE76 budget (contract: < 0.5), else
  the next tier is tried, ending at exact — no user knob needed.""",
    "input_matrix": """\
--input-matrix auto|bt709|smpte170m|bt470bg|bt2020nc|none
  YUV->RGB matrix for the LUT input. auto: probe's colorspace when
  recognized, else bt709 for HD. none: skip forcing (use source tags).""",
    "output_tags": """\
--output-tags bt709|inherit|none
  Container color metadata on the output. bt709 (default with a LUT):
  tag bt709 primaries/transfer/matrix + tv range — the reference's "the
  LUT output is display-referred Rec.709" stance. inherit: copy the
  source's tags (requires metadata inheritance on). none: write no tags.""",
    "dither": """\
--dither none|error_diffusion|ordered|random
  Bit-depth-reduction dither (matters with force_8bit or 10->8 paths).
  error_diffusion: exact serial Floyd-Steinberg on the host via the native
  C++ helper (zscale-faithful); if the helper is unavailable it degrades
  to ordered with a note. NOTE: the FS recurrence is inherently serial and
  runs on one CPU core — the fixed-point fast path measures ~52 ms per 4K
  4:2:0 frame (~19 fps ceiling, overlapped with device compute) vs ~60 fps
  for the in-kernel dithers; prefer ordered/random unless
  zscale-exact output is required. ordered: zero-mean 16x16 Bayer inside
  the TPU pipeline. random: stateless position-hash stochastic rounding
  (no tile structure, bit-reproducible across runs).""",
    "audio": """\
--audio-codec copy|aac|flac|alac|ac3|eac3|mp2|opus|vorbis|none
  copy (default): remux the source audio stream untouched. Any other name
  transcodes through the bundled encoder with automatic sample-format
  negotiation (e.g. alac takes s16/s32 planar; ac3/opus/vorbis take
  fltp). mp3 is offered by the reference UI but absent from the bundled
  libraries — the plan notes the copy fallback up front. --audio-bitrate
  sets the target rate. --sample-rate / --channels resample/remix like
  the reference's -ar/-ac (a rate the encoder can't take snaps to its
  nearest supported one, e.g. opus 44100 -> 48000); blank inherits.""",
    "concurrency": """\
--concurrency N (1-16)
  Parallel tasks. Each task runs its own decode/render/encode pipeline;
  the TPU time-slices between render steps. 1 (default, like the
  reference) is usually right for one chip — raise it when tasks are
  host-bound (decode/encode heavy, small frames).""",
    "watch": """\
--watch
  Interactive queue monitor: one live row per task (status, progress bar,
  percent), aggregate queue percent in the header, keys 1-9 cancel that
  row's task, 'a' cancels all unfinished, 'q' leaves the monitor (the
  queue keeps running). The headless analog of the reference's window.""",
    "serve": """\
lut-tpu serve --socket PATH [--http PORT] [--queue-file PATH] [--warmup]
  Warm render daemon: one process owns the chip and keeps the compiled
  programs and prepared LUTs resident, so a job costs render time instead
  of process startup + compile. Jobs arrive as JSON lines over the Unix
  socket (drive ad hoc with `lut-tpu client`); --warmup precompiles the
  production program set first (one-time per machine via the persistent
  cache). --http PORT additionally serves the web GUI — the browser
  analog of the reference's main window: full parameter panel with
  per-field help, LUT library (incl. uploading a .cube from the browser
  to the daemon machine), presets, live concurrency, live queue table
  with progress/cancel/reprocess/info/output download. Binds 127.0.0.1
  by default; the trust model matches the socket (clients submit
  server-side paths). --queue-file makes the queue durable: it persists
  atomically on every state change, and a restarted daemon restores it
  — interrupted tasks come back pending and resume automatically
  (crash/restart recovery; an unreadable file is reported and moved
  aside as .corrupt).""",
    "queue": """\
queue persistence
  --save-queue FILE writes the queue state (tasks, params, status) as
  JSON; `lut-tpu resume FILE` reloads it — interrupted RUNNING tasks
  come back as PENDING. `resume --reapply <flags>` re-snapshots fresh
  parameters onto every pending task first (smart defaults re-run per
  source, fresh output names), mirroring the reference's behavior when
  Start is pressed after changing settings.""",
    "naming": """\
output naming
  Outputs land in --out-dir (default <source>/output) as stem_out.ext;
  collisions get _1, _2... suffixes (never overwritten). Pro masters:
  stem_master.mov in --master-dir. Covers: stem_cover.jpg.""",
}

ALIASES = {
    "bit-depth": "bit_depth", "bit_depth_policy": "bit_depth",
    "lut_interp": "interp", "tetrahedral": "interp",
    "zscale_dither": "dither", "lut_input_matrix": "input_matrix",
    "lut_output_tags": "output_tags", "tags": "output_tags",
    "matrix": "input_matrix", "save-queue": "queue", "resume": "queue",
    "reapply": "queue", "master-dir": "master_dir", "pro": "mode",
    "fast": "mode", "monitor": "watch", "output": "naming",
    "audio-codec": "audio",
    # one topic per ProcessingParams field (reference help-parity,
    # main_window.py:1269-1622): field names resolve directly.
    "video_codec": "codec", "audio_codec": "audio",
    "processing_mode": "mode", "generate_cover": "cover",
    "inherit_color_metadata": "inherit_metadata",
    "enc-preset": "preset", "enc-profile": "profile",
    "audio-bitrate": "audio_bitrate", "sample-rate": "sample_rate",
    "out-dir": "out_dir", "output-dir": "out_dir",
    "intermediate_dir": "master_dir", "tpu": "hardware",
    "pix-fmt": "pix_fmt",
    "web": "serve", "gui": "serve", "daemon": "serve", "client": "serve",
    "http": "serve",
}


def help_text(topic: str = "") -> str:
    if not topic:
        lines = ["topics (lut-tpu help <topic>):", ""]
        for name in sorted(TOPICS):
            first = TOPICS[name].splitlines()[0]
            lines.append(f"  {name:<14} {first}")
        return "\n".join(lines)
    key = ALIASES.get(topic, topic)
    if key in TOPICS:
        return TOPICS[key]
    return (f"unknown topic {topic!r}; run `lut-tpu help` for the list")
