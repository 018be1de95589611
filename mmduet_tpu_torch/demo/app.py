"""Zero-dependency web demo (stdlib http.server).

Equivalent of the reference Gradio demo (`demo/app.py`) but runnable in
this environment (no gradio): serves a single page plotting per-frame
informative/relevance scores live, streaming assistant responses, with a
chat box injecting user queries mid-stream. The model streams the video in
a background thread paced at the configured frame interval; the page polls
``/state``.

    python -m mmduet_tpu_torch.demo.app --tiny_random --video path.mp4 \
        --stream_end_prob_threshold 0.3 [--port 7860]

A Gradio variant with the reference's exact UI controls is in
`mmduet_tpu_torch.demo.gradio_app` (requires gradio installed).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

PAGE = """<!DOCTYPE html>
<html><head><title>MMDuet-TPU live demo</title>
<style>
body { font-family: sans-serif; margin: 2em; max-width: 900px; }
#chart { border: 1px solid #ccc; width: 100%; height: 220px; }
#chat { border: 1px solid #ccc; padding: 1em; min-height: 8em; }
.assistant { color: #0a6; } .user { color: #06a; }
</style></head>
<body>
<h2>MMDuet-TPU — streaming video-text duet</h2>
<canvas id="chart" width="880" height="220"></canvas>
<div>informative <span style="color:#d44">&#9632;</span> &nbsp;
     relevance <span style="color:#48d">&#9632;</span>
     &nbsp; frame <span id="fidx">0</span>, t=<span id="t">0</span>s</div>
<div id="chat"></div>
<form onsubmit="send(); return false;">
  <input id="msg" size="60" placeholder="ask about the video..."
         onfocus="fetch('/pause')"/>
  <button>send</button>
  <button type="button" id="pp" onclick="toggle()">pause</button>
</form>
<script>
function esc(x) {  // chat text renders via innerHTML: escape it
  return String(x).replace(/&/g, '&amp;').replace(/</g, '&lt;')
                  .replace(/>/g, '&gt;').replace(/"/g, '&quot;');
}
async function poll() {
  const r = await fetch('/state'); const s = await r.json();
  const c = document.getElementById('chart').getContext('2d');
  c.clearRect(0, 0, 880, 220);
  const n = s.informative.length;
  function line(vals, color) {
    c.strokeStyle = color; c.beginPath();
    vals.forEach((v, i) => {
      const x = i / Math.max(s.total_frames - 1, 1) * 870 + 5;
      const y = 210 - v * 200;
      i ? c.lineTo(x, y) : c.moveTo(x, y);
    });
    c.stroke();
  }
  line(s.informative, '#d44'); line(s.relevance, '#48d');
  document.getElementById('fidx').textContent = n;
  document.getElementById('t').textContent = (s.time || 0).toFixed(1);
  document.getElementById('chat').innerHTML = s.chat.map(
    m => `<div class="${esc(m.role)}"><b>[${m.time.toFixed(1)}s ${esc(m.role)}]</b> ${esc(m.content)}</div>`
  ).join('');
  document.getElementById('pp').textContent = s.paused ? 'resume' : 'pause';
  setTimeout(poll, 500);
}
async function toggle() {
  const r = await fetch('/state'); const s = await r.json();
  await fetch(s.paused ? '/resume' : '/pause');
}
async function send() {
  const v = document.getElementById('msg').value;
  document.getElementById('msg').value = '';
  await fetch('/query?text=' + encodeURIComponent(v));
  await fetch('/resume');  // reference demo resumes on submit
}
poll();
</script></body></html>"""


class DemoState:
    def __init__(self, engine, frames, fps, realtime=True):
        self.engine = engine
        self.frames = frames
        self.fps = fps
        self.realtime = realtime
        self.chat = []
        self.lock = threading.Lock()
        self.pending_queries = []
        self.done = False
        # reference demo's pause Event (`demo/app.py:13-14,185-197`):
        # set = streaming; typing in the chat box pauses the video so a
        # query lands at the intended moment, submit/resume continues
        self.pause_event = threading.Event()
        self.pause_event.set()

    def run(self):
        eng = self.engine
        eng.reset()
        eng.set_fps(fps=self.fps)
        eng.input_video_stream(self.frames)
        while True:
            self.pause_event.wait()
            with self.lock:
                for q in self.pending_queries:
                    eng.encode_given_query(q)
                    self.chat.append(
                        {"role": "user", "content": q, "time": eng.video_time}
                    )
                self.pending_queries = []
            t0 = time.perf_counter()
            result = eng.input_one_frame()
            if result is None:
                self.done = True
                return
            if result["response"]:
                with self.lock:
                    self.chat.append(
                        {
                            "role": "assistant",
                            "content": result["response"],
                            "time": result["time"],
                        }
                    )
            if self.realtime:  # pace to wall clock like the reference demo
                time.sleep(max(0.0, eng.frame_interval - (time.perf_counter() - t0)))

    def snapshot(self):
        eng = self.engine
        with self.lock:
            return {
                "informative": [d["informative_score"] for d in eng.debug_data_list],
                "relevance": [d["relevance_score"] for d in eng.debug_data_list],
                "chat": list(self.chat),
                "time": eng.video_time,
                "total_frames": len(eng.frame_times),
                "done": self.done,
                "paused": not self.pause_event.is_set(),
            }


def make_handler(state: DemoState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body, ctype = PAGE.encode(), "text/html"
            elif url.path == "/state":
                body, ctype = json.dumps(state.snapshot()).encode(), "application/json"
            elif url.path == "/query":
                text = parse_qs(url.query).get("text", [""])[0]
                if text.strip():
                    with state.lock:
                        state.pending_queries.append(text.strip())
                body, ctype = b"{}", "application/json"
            elif url.path == "/pause":
                state.pause_event.clear()
                body, ctype = b"{}", "application/json"
            elif url.path == "/resume":
                state.pause_event.set()
                body, ctype = b"{}", "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def main(argv=None):
    from ..data.video import decode_video
    from ..eval.inference import build_argparser, build_engine

    p = argparse.ArgumentParser(parents=[build_argparser()], add_help=False,
                                conflict_handler="resolve")
    p.add_argument("--test_fname", default=None)
    p.add_argument("--input_dir", default=None)
    p.add_argument("--output_fname", default=None)
    p.add_argument("--video", required=True)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--no_realtime", action="store_true",
                   help="stream as fast as the chip allows")
    args = p.parse_args(argv)

    from .live import LiveInferForDemo
    import mmduet_tpu_torch.eval.inference as infer_cli

    # reuse the CLI's model construction, but with the demo engine class
    engine = build_engine(args)
    engine.__class__ = LiveInferForDemo
    # interactive serving: compile every hot shape up front so the first
    # frame/query/response of a live session never stalls on XLA
    engine.prewarm(vision=True)

    # decode at the MODEL's frame resolution unless explicitly overridden
    resolution = args.frame_resolution or engine.cfg.frame_resolution
    frames, fps, duration = decode_video(
        args.video, args.frame_fps, resolution, args.max_num_frames
    )
    print(f"loaded {len(frames)} frames @ {fps}fps from {args.video}")
    state = DemoState(engine, frames, fps, realtime=not args.no_realtime)
    threading.Thread(target=state.run, daemon=True).start()

    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(state))
    print(f"demo at http://localhost:{args.port}/")
    server.serve_forever()


if __name__ == "__main__":
    main()
