"""AVSyncD serving daemon: load the model stack once and answer generation
requests over HTTP.  Port of scripts/animation_serve.py, plus `--device`:

    python3 -m asva_tpu_torch.scripts.animation_serve --port 8765 \
        --checkpoint_modules_dir exps/run/ckpts/checkpoint-37000/modules \
        [--warmup] [--device cpu]

`--port 0` binds a free port; the `listening on HOST:PORT` line names it.

Endpoints:
  GET  /healthz    -> {"ok": true, "requests": N, "warm": true|false}
  POST /generate   -> body JSON:
        {"image_path": ..., "audio_path": ..., "video_path": ...,
         "category_text_encoding_path": ..., "num_clips": 3,
         "num_inference_steps": 50, "audio_guidance_scale": 4.0,
         "text_guidance_scale": 1.0, "sampler": "plms", "seed": 0,
         "save_template": "<dir>/out"}
     -> {"ok": true, "outputs": [...mp4 paths...], "latency_s": ...}
     (without a save_template the clips go to <tmp>/asva_serve_<id>)

Requests are generated one at a time under a lock (one card); each HTTP
request has its own thread.  `--warmup` runs one pipeline call at the
default shapes (batch `--warmup_clips`, `--warmup_steps` steps, zero
inputs) before the server answers: on the card that call builds the
kernels and lets cuDNN pick its algorithms, so that /healthz says warm
only when the first request will not pay for them.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .common import add_device_flag, compute_dtype


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--checkpoint_modules_dir", default=None)
    p.add_argument("--sd_root", default="pretrained/stable-diffusion-v1-5")
    p.add_argument("--null_text_encoding_path",
                   default="pretrained/openai-clip-l_null_text_encoding.pt")
    p.add_argument("--config_file", default=None,
                   help="optional train-style YAML; model.unet/.audio_encoder "
                        "override the full-size defaults")
    p.add_argument("--image_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--video_fps", type=int, default=6)
    p.add_argument("--video_num_frame", type=int, default=12)
    p.add_argument("--warmup", action="store_true",
                   help="run one default-shape pipeline call before "
                        "serving (zero inputs; builds the kernels)")
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--warmup_clips", type=int, default=3,
                   help="batch of the warmup call (= the num_clips a "
                        "default request stacks into one call)")
    p.add_argument("--max_requests", type=int, default=0,
                   help="exit after N successful requests (0 = serve "
                        "forever); for smoke tests")
    add_device_flag(p)
    return p


def build_pipeline(args):
    from ..runtime import load_animation_pipeline
    unet_config = None
    n_segment = args.video_num_frame
    if args.config_file:
        from ..config import AnimationJobConfig
        cfg = AnimationJobConfig.from_yaml(args.config_file)
        unet_config = cfg.unet
        n_segment = cfg.n_segment
    pipeline = load_animation_pipeline(
        checkpoint_modules_dir=args.checkpoint_modules_dir or None,
        sd_root=args.sd_root or None,
        null_text_encoding_path=args.null_text_encoding_path or None,
        n_segment=n_segment, device=args.device,
        dtype=compute_dtype(args.device), unet_config=unet_config)
    return pipeline, n_segment


def warmup(pipeline, args, n_segment: int) -> None:
    """One pipeline call at a default request's shapes: the clips of one
    request stacked into a batch, zero image, mel and text."""
    import torch
    h, w = args.image_size
    b, dev = args.warmup_clips, pipeline.device
    pipeline(torch.zeros((b, h, w, 3), device=dev),
             torch.zeros((b, 128, 204, 1), device=dev),
             torch.zeros((b, 77, 768), device=dev), video_length=n_segment,
             num_inference_steps=args.warmup_steps, audio_guidance_scale=4.0,
             text_guidance_scale=1.0, sampler="plms",
             generator=torch.Generator(device=dev).manual_seed(0),
             broadcast_rng=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, on_listen=None):
    """Serve until --max_requests successful requests (or forever).
    `on_listen`, when given, is called with the listening server: an
    in-process caller's handle on its `server_address` and `shutdown()`."""
    args = parser().parse_args(argv)
    from ..pipelines.generate import generate_videos
    from ..runtime import load_null_text_encoding

    t0 = time.time()
    pipeline, n_segment = build_pipeline(args)
    print(f"[serve] models loaded in {time.time() - t0:.1f}s "
          f"(n_segment={n_segment})", flush=True)

    state = {"requests": 0, "warm": False}
    lock = threading.Lock()   # one card: generation is serialised
    # every HTTP request has its own thread: the id is drawn under the lock,
    # never read from state["requests"], which two concurrent POSTs would
    # share (the second overwriting the first's default-template mp4s)
    request_ids = itertools.count()

    if args.warmup:
        t0 = time.time()
        warmup(pipeline, args, n_segment)
        state["warm"] = True
        print(f"[serve] warmup {time.time() - t0:.2f}s "
              f"({args.warmup_clips} clips, {args.warmup_steps} steps)",
              flush=True)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            print("[serve]", fmt % a, flush=True)

        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":   # never waits for a generation
                self._reply(200, {"ok": True, **state})
            else:
                self._reply(404, {"ok": False, "error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"ok": False, "error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                with lock:
                    req_id = next(request_ids)
                save_template = req.get("save_template") or os.path.join(
                    tempfile.gettempdir(), f"asva_serve_{req_id}")
                enc = None
                enc_path = req.get("category_text_encoding_path")
                if enc_path:
                    enc = load_null_text_encoding(enc_path, args.device)
                num_clips = int(req.get("num_clips", 3))
                t0 = time.time()
                with lock:
                    generate_videos(
                        pipeline,
                        image_path=req.get("image_path", ""),
                        audio_path=req.get("audio_path", ""),
                        video_path=req.get("video_path", ""),
                        category_text_encoding=enc,
                        image_size=tuple(args.image_size),
                        video_fps=args.video_fps,
                        video_num_frame=n_segment,
                        num_clips_per_video=num_clips,
                        audio_guidance_scale=float(
                            req.get("audio_guidance_scale", 4.0)),
                        text_guidance_scale=float(
                            req.get("text_guidance_scale", 1.0)),
                        num_inference_steps=int(
                            req.get("num_inference_steps", 50)),
                        seed=int(req.get("seed", 0)),
                        save_template=save_template,
                        sampler=req.get("sampler", "plms"))
                dt = time.time() - t0
                outs = [f"{save_template}_clip-{i:02d}.mp4"
                        for i in range(num_clips)]
                outs = [o for o in outs if os.path.exists(o)]
                with lock:
                    state["requests"] += 1
                    state["warm"] = True
                self._reply(200, {"ok": True, "outputs": outs,
                                  "latency_s": round(dt, 3)})
            except Exception as e:   # the server stays up; the client sees it
                traceback.print_exc()
                self._reply(500, {"ok": False, "error": str(e)})
            with lock:
                done = (args.max_requests
                        and state["requests"] >= args.max_requests)
            if done:
                threading.Thread(target=httpd.shutdown, daemon=True).start()

    httpd = ThreadingHTTPServer((args.host, args.port), Handler)
    host, port = httpd.server_address[:2]
    print(f"[serve] listening on {host}:{port}", flush=True)
    if on_listen is not None:
        on_listen(httpd)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    print("[serve] done", flush=True)


if __name__ == "__main__":
    main()
