"""Minimal HTTP front end over the port's serve.Predictor.

Counterpart of ``livespeechportraits_tpu/server.py``: a stdlib http.server
that takes a wav upload and returns the rendered video.

    python -m livespeechportraits_torch.server --quantize --artifact model.npz --port 8080

    curl -X POST --data-binary @input.wav -H 'Content-Type: audio/wav' \\
         http://localhost:8080/animate -o out.avi

POST /animate returns the .avi with X-Frames and X-Wall-Seconds headers;
POST /stream[?latency_cap=N] returns the frames as a live multipart MJPEG
stream (multipart/x-mixed-replace) while the clip is still being generated;
GET /healthz returns the status.  Writing the .avi and the JPEG parts needs
cv2: without it /animate and /stream answer 500.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
from scipy.io import wavfile

from livespeechportraits_torch.pipeline import video as video_mod
from livespeechportraits_torch.serve import Predictor


def make_handler(predictor: Predictor):
    # One request renders at a time (one device, one in-order stream); the
    # lock serialises /animate and /stream while /healthz answers on its own
    # thread.
    device_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet default logging
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, b"not found", "text/plain")
                return
            info = {"status": "ok", "person": predictor._person,
                    "device": str(predictor.device),
                    "max_audio_seconds": predictor.max_audio_seconds}
            self._send(200, json.dumps(info).encode(), "application/json")

        def _read_wav(self):
            """The request's body, validated as a wav; None after answering
            400."""
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._send(400, b"empty body", "text/plain")
                return None
            payload = self.rfile.read(length)
            try:
                wavfile.read(io.BytesIO(payload))
            except Exception as e:  # a boundary: report the failure to the client
                self._send(400, f"error: {e}".encode(), "text/plain")
                return None
            return payload

        def _stream(self, wav_path: str) -> None:
            """The frames leave as JPEG parts of a multipart stream while the
            clip is still being generated: the first after the pipeline's
            latency (cut to N frames by ?latency_cap=N).  The device lock is
            held only while the generator advances, so a slow client stalls
            no one else, and a dead one times out after 60 s.  Frames cross
            from the device as yuv420: the JPEG re-encode subsamples chroma
            anyway.  The end is the closing boundary and the connection's
            close (no Content-Length)."""
            qs = parse_qs(urlparse(self.path).query)
            cap = int(qs["latency_cap"][0]) if qs.get("latency_cap") else None
            gen = predictor.stream(wav_path, transfer="yuv420", smooth_latency_cap=cap)
            try:
                try:
                    with device_lock:
                        batch = next(gen, None)
                except Exception as e:  # a boundary: nothing is sent yet
                    self._send(500, f"error: {e}".encode(), "text/plain")
                    return
                self.connection.settimeout(60.0)
                self.send_response(200)
                self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                while batch is not None:
                    for frame in batch:
                        ok, jpg = video_mod.cv2.imencode(
                            ".jpg", np.ascontiguousarray(frame[..., ::-1]))  # RGB -> BGR
                        if not ok:
                            raise RuntimeError("JPEG encoding failed")
                        part = jpg.tobytes()
                        self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n"
                                         + f"Content-Length: {len(part)}\r\n\r\n".encode()
                                         + part + b"\r\n")
                    with device_lock:
                        batch = next(gen, None)
                self.wfile.write(b"--frame--\r\n")
            finally:
                gen.close()  # releases the stream's threads if it ended early

        def do_POST(self):
            path = self.path.split("?")[0]
            if path not in ("/animate", "/stream"):
                self._send(404, b"not found", "text/plain")
                return
            if path == "/stream" and video_mod.cv2 is None:
                self._send(500, b"/stream encodes JPEG parts with cv2 (opencv-python), "
                                b"which is not importable here", "text/plain")
                return
            payload = self._read_wav()
            if payload is None:
                return
            with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                f.write(payload)
                wav_path = f.name
            try:
                if path == "/stream":
                    try:
                        self._stream(wav_path)
                    except Exception:  # a boundary: the headers are out; log it
                        traceback.print_exc()
                    return
                try:
                    with device_lock:
                        result = predictor.predict(wav_path)
                        # read inside the lock: the next predict() empties
                        # the shared results directory
                        with open(result.video_path, "rb") as f:
                            body = f.read()
                except Exception as e:  # a boundary: report the failure to the client
                    self._send(400, f"error: {e}".encode(), "text/plain")
                    return
            finally:
                os.unlink(wav_path)
            self.send_response(200)
            self.send_header("Content-Type", "video/x-msvideo")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Frames", str(result.nframe))
            self.send_header("X-Wall-Seconds", f"{result.wall_s:.3f}")
            self.end_headers()
            self.wfile.write(body)

    return Handler


def serve_forever(person_id: str = "Synthetic", port: int = 8080, image_size: int = 512,
                  config_dir: str = "./config", max_audio_seconds: float = 10.0,
                  quantize: bool = False, artifact: str = "", data_parallel: bool = False,
                  **ckpts: str) -> None:
    """ckpts: f2f_ckpt, a2f_ckpt, a2h_ckpt, apc_ckpt, the port trainer's
    checkpoint directories; data_parallel: each request's render batch over
    every visible card (Predictor.setup)."""
    predictor = Predictor(max_audio_seconds=max_audio_seconds)
    predictor.setup(person_id, config_dir=config_dir, image_size=image_size,
                    quantize=quantize, artifact=artifact or None,
                    data_parallel=data_parallel, **ckpts)
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(predictor))
    print(f"serving '{person_id}' on :{port} on {predictor.device} "
          "(POST /animate, POST /stream, GET /healthz)")
    try:
        server.serve_forever()  # until shutdown() or KeyboardInterrupt
    finally:
        server.server_close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="HTTP serving front end of the PyTorch port")
    p.add_argument("--id", default="Synthetic")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--config_dir", default="./config")
    p.add_argument("--max_audio_seconds", type=float, default=10.0)
    p.add_argument("--quantize", action="store_true",
                   help="int8 renderer with calibrated static scales (frames within "
                        "PSNR > 30 dB of the float path)")
    p.add_argument("--artifact", default="",
                   help="serving-model .npz: load the models from it if it exists, else "
                        "build them (honouring --quantize) and save them to it")
    for stage in ("f2f", "a2f", "a2h", "apc"):
        p.add_argument(f"--{stage}_ckpt", default="",
                       help=f"serve the {stage} stage from a trainer run's ckpt directory "
                            "(python -m livespeechportraits_torch.train)")
    p.add_argument("--data_parallel", action="store_true",
                   help="split each request's render batch over every visible card (frames "
                        "are independent: no communication but the gather)")
    args = p.parse_args(argv)
    serve_forever(args.id, args.port, args.image_size, args.config_dir, args.max_audio_seconds,
                  quantize=args.quantize, artifact=args.artifact,
                  data_parallel=args.data_parallel, f2f_ckpt=args.f2f_ckpt,
                  a2f_ckpt=args.a2f_ckpt, a2h_ckpt=args.a2h_ckpt, apc_ckpt=args.apc_ckpt)


if __name__ == "__main__":
    main()
