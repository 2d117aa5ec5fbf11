"""Minimal HTTP front end over the port's serve.Predictor.

Counterpart of ``livespeechportraits_tpu/server.py``: a stdlib http.server
that takes a wav upload and returns the rendered video.

    python -m livespeechportraits_torch.server --quantize --artifact model.npz --port 8080

    curl -X POST --data-binary @input.wav -H 'Content-Type: audio/wav' \\
         http://localhost:8080/animate -o out.avi

POST /animate returns the .avi with X-Frames and X-Wall-Seconds headers;
GET /healthz returns the status; POST /stream answers 501 (streaming is
ROADMAP item 13).  Writing the .avi needs cv2.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from scipy.io import wavfile

from livespeechportraits_torch.serve import Predictor


def make_handler(predictor: Predictor):
    # One request renders at a time (one device, one in-order stream); the
    # lock serialises /animate while /healthz answers on its own thread.
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

        def do_POST(self):
            path = self.path.split("?")[0]
            if path == "/stream":
                self._send(501, b"/stream is not ported (ROADMAP item 13: streaming)",
                           "text/plain")
                return
            if path != "/animate":
                self._send(404, b"not found", "text/plain")
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._send(400, b"empty body", "text/plain")
                return
            payload = self.rfile.read(length)
            try:
                wavfile.read(io.BytesIO(payload))  # validate before rendering
                with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                    f.write(payload)
                    wav_path = f.name
                try:
                    with device_lock:
                        result = predictor.predict(wav_path)
                        # read inside the lock: the next predict() empties
                        # the shared results directory
                        with open(result.video_path, "rb") as f:
                            body = f.read()
                finally:
                    os.unlink(wav_path)
            except Exception as e:  # a boundary: report the failure to the client
                self._send(400, f"error: {e}".encode(), "text/plain")
                return
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
                  quantize: bool = False, artifact: str = "") -> None:
    predictor = Predictor(max_audio_seconds=max_audio_seconds)
    predictor.setup(person_id, config_dir=config_dir, image_size=image_size,
                    quantize=quantize, artifact=artifact or None)
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(predictor))
    print(f"serving '{person_id}' on :{port} on {predictor.device} "
          "(POST /animate, GET /healthz)")
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
    args = p.parse_args(argv)
    serve_forever(args.id, args.port, args.image_size, args.config_dir, args.max_audio_seconds,
                  quantize=args.quantize, artifact=args.artifact)


if __name__ == "__main__":
    main()
