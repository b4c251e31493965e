"""HTTP inference server (port of ``server.py``) over ``serving.WorldModel``.

- ``GET  /healthz`` → model class, parameter count, device platform.
- ``POST /observe`` → filter an observation batch; returns a ``state_id``
  handle for the final posterior latent (and, with ``"decode": true``, the
  posterior reconstructions under ``recon``).
- ``POST /imagine`` → prior-only rollout from a ``state_id`` under an action
  plan; returns decoded ``frames`` (``"decode"`` defaults to true) and a new
  ``state_id`` for a chained continuation.

Arrays travel as JSON nested lists, or as npz: send ``np.savez`` bytes with
``Content-Type: application/x-npz`` (same field names, scalars as 0-d
arrays) and the response comes back as npz, one nesting level flattened
with ``/``. Errors are always JSON. Latents stay on the device in a bounded
LRU store behind opaque ids. One lock serialises device work, and every
request runs alone with exact per-seed results; request coalescing is not
ported yet.

Run: ``python -m multimodal_mtrssm_tpu_torch.server [--model mrssm|mmtrssm]
[--checkpoint x.ckpt] [--device cuda] [--port 8000]``.
"""

from __future__ import annotations

import io
import json
import threading
import uuid
import zipfile
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from multimodal_mtrssm_tpu_torch.serving import WorldModel
from multimodal_mtrssm_tpu_torch.utils import count_params


class UnknownStateError(KeyError):
    """A state_id handle that is not (or no longer) in the LRU store."""


class _StateStore:
    """Bounded LRU map: state_id → on-device latent state."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._d: OrderedDict[str, object] = OrderedDict()
        self._lock = threading.Lock()

    def put(self, state) -> str:
        sid = uuid.uuid4().hex[:16]
        with self._lock:
            self._d[sid] = state
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
        return sid

    def get(self, sid: str):
        with self._lock:
            state = self._d.get(sid)
            if state is not None:
                self._d.move_to_end(sid)
            return state


class InferenceServer:
    """Serve a ``WorldModel`` over HTTP. ``port=0`` picks a free port
    (``.port`` after construction)."""

    def __init__(self, world_model: WorldModel, host: str = "127.0.0.1", port: int = 8000,
                 state_capacity: int = 64):
        self.wm = world_model
        self.states = _StateStore(state_capacity)
        # Requests serialise on the device anyway; the lock keeps the
        # kernels' launch counts and the state store consistent.
        self._device_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code: int, payload: dict, binary: bool = False) -> None:
                if binary:
                    body, ctype = _payload_to_npz(payload), "application/x-npz"
                else:
                    body, ctype = json.dumps(payload).encode(), "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, server._health())
                else:
                    self._send(404, {"error": f"unknown route {self.path}"})

            def do_POST(self):
                ctype = self.headers.get("Content-Type") or ""
                binary = "npz" in ctype or "octet-stream" in ctype
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    req = _npz_to_request(body) if binary else json.loads(body or b"{}")
                except (ValueError, OSError, EOFError, zipfile.BadZipFile) as e:
                    self._send(400, {"error": f"bad request body: {e}"})
                    return
                try:
                    if self.path == "/observe":
                        self._send(200, server._observe(req, raw=binary), binary)
                    elif self.path == "/imagine":
                        self._send(200, server._imagine(req, raw=binary), binary)
                    else:
                        self._send(404, {"error": f"unknown route {self.path}"})
                except UnknownStateError as e:
                    self._send(404, {"error": f"unknown state_id {e.args[0]!r}"})
                except KeyError as e:
                    self._send(400, {"error": f"missing field {e.args[0]!r}"})
                except (ValueError, TypeError, IndexError, OverflowError) as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — device failures surface as HTTP 500
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # ---- endpoints -----------------------------------------------------------
    def _health(self) -> dict:
        device = self.wm.device
        return {
            "ok": True,
            "model": type(self.wm.model).__name__,
            "n_params": count_params(self.wm.model),
            "platform": "gpu" if device.type == "cuda" else device.type,
            "device": str(device),
        }

    def _observe(self, req: dict, raw: bool = False) -> dict:
        actions = np.asarray(req["actions"], np.float32)
        audio = np.asarray(req["audio"], np.float32)
        vision = np.asarray(req["vision"], np.float32)
        return self._observe_one(actions, audio, vision, int(req.get("seed", 0)),
                                 bool(req.get("decode", False)), raw)

    def _observe_one(self, actions, audio, vision, seed: int, decode: bool, raw: bool) -> dict:
        """One /observe request, one device call (exact per-seed semantics)."""
        decoded = None
        with self._device_lock:
            posterior, _ = self.wm.observe(actions, audio, vision, seed)
            out = {"state_id": self.states.put(posterior[:, -1].clone()),
                   "batch": int(actions.shape[0]), "t": int(actions.shape[1])}
            if decode:
                decoded = self.wm.decode(posterior)
        if decoded is not None:
            # The copy to the host waits for the device outside the lock.
            out["recon"] = _frames_out(decoded, raw)
        return out

    def _imagine(self, req: dict, raw: bool = False) -> dict:
        state = self.states.get(str(req["state_id"]))
        if state is None:
            raise UnknownStateError(str(req["state_id"]))
        actions = np.asarray(req["actions"], np.float32)
        return self._imagine_one(state, actions, int(req.get("seed", 0)),
                                 bool(req.get("decode", True)), raw)

    def _imagine_one(self, state, actions, seed: int, decode: bool, raw: bool) -> dict:
        """One /imagine request, one device call (exact per-seed semantics)."""
        decoded = None
        with self._device_lock:
            imagined = self.wm.imagine(actions, state, seed)
            out = {"state_id": self.states.put(imagined[:, -1].clone()), "t": int(actions.shape[1])}
            if decode:
                decoded = self.wm.decode(imagined)
        if decoded is not None:
            out["frames"] = _frames_out(decoded, raw)
        return out

    # ---- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Serve in a daemon thread (returns immediately)."""
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        """Serve in the calling thread."""
        self.httpd.serve_forever()

    def stop(self) -> None:
        """Stop serving and close the socket."""
        if self._thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _frames_out(decoded: dict, raw: bool) -> dict:
    """Decoded frames → response payload: numpy (npz framing) or lists."""
    arrays = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in decoded.items()}
    return arrays if raw else {k: v.tolist() for k, v in arrays.items()}


def _npz_to_request(body: bytes) -> dict:
    """npz request bytes → the dict the JSON path produces (0-d arrays
    unwrap to Python scalars)."""
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: (v.item() if v.ndim == 0 else v) for k, v in z.items()}


def _payload_to_npz(payload: dict) -> bytes:
    """Response dict → npz bytes; one nesting level flattens with ``/``."""
    flat: dict[str, np.ndarray] = {}
    for k, v in payload.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                flat[f"{k}/{k2}"] = np.asarray(v2)
        else:
            flat[k] = np.asarray(v)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def main(argv: list[str] | None = None) -> None:
    """CLI entry: serve ``MoPoEMRSSM(MRSSMConfig())`` or
    ``MoPoEMMTRSSM(MMTRSSMConfig())`` with weights from a Lightning ``.ckpt``
    (``scripts/export_torch_checkpoint.py`` writes one) or, without one,
    from a seeded init."""
    import argparse

    import torch

    from multimodal_mtrssm_tpu_torch.models import MoPoEMMTRSSM, MoPoEMRSSM
    from multimodal_mtrssm_tpu_torch.train.weights import load_lightning_checkpoint

    families = {"mrssm": MoPoEMRSSM, "mmtrssm": MoPoEMMTRSSM}
    ap = argparse.ArgumentParser(prog="serve")
    ap.add_argument("--model", choices=sorted(families), default="mrssm",
                    help="model family, at its reference config")
    ap.add_argument("--checkpoint", help="Lightning .ckpt of the model at the reference config")
    ap.add_argument("--seed", type=int, default=0, help="init seed when no checkpoint is given")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on; 'cpu' must be asked for explicitly")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"serve: --device {args.device} but CUDA is not available; "
                         "pass --device cpu to serve on the CPU")

    model = families[args.model]().init(torch.Generator().manual_seed(args.seed))
    if args.checkpoint:
        load_lightning_checkpoint(model, args.checkpoint)
    server = InferenceServer(WorldModel(model, args.device), host=args.host, port=args.port)
    print(f"serving {type(model).__name__} on http://{args.host}:{server.port} "
          "(/healthz /observe /imagine)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
