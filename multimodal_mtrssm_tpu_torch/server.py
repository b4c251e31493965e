"""HTTP inference server (port of ``server.py``) over ``serving.WorldModel``.

- ``GET  /healthz`` → model class, parameter count, device platform, and
  the coalescer's counts.
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
LRU store behind opaque ids. One lock serialises device work.

Request coalescing (``batch_window_ms > 0``): concurrent requests of a
route are collected for up to the window (or ``batch_max`` of them) by a
long-lived batcher thread and run as one device call
(``WorldModel.observe_many`` / ``imagine_many``): batches concatenate on
the batch axis and shorter sequences zero-pad to the longest. Every
request's result equals what it gets alone: the recurrences and rollouts
are causal and their rows independent, observe noise is drawn per request,
and the rollout kernels key each row by its request's seed and its index
in that request. (JAX folds every co-occupant's seed into one key, so its
coalesced samples depend on the other requests in the window; the port
does not copy that.) JAX's power-of-two shape buckets and its work gate
(``coalesce_max_work``) are not ported: the buckets bound XLA's compile
cache, which eager PyTorch does not have, and the gate's threshold was
measured on a TPU. If a coalesced call fails (a malformed request among
them), each of its requests is re-run alone on the same route, so the bad
one fails by itself; ``retries`` counts those re-runs. Window 0, the
default, runs every request alone as it arrives, through the same batch
function with a batch of one.

Run: ``python -m multimodal_mtrssm_tpu_torch serve --config x.yaml
--checkpoint runs/x/checkpoints [--batch-window-ms 5] [--device cuda]``,
or at a reference config with ``--model mrssm|mmtrssm [--checkpoint
x.ckpt]``.
"""

from __future__ import annotations

import io
import json
import threading
import time
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


class _Pending:
    """One enqueued request awaiting a coalesced device call."""

    def __init__(self, seed: int, decode: bool, raw: bool):
        self.seed = seed
        self.decode = decode
        self.raw = raw
        self.event = threading.Event()
        self.result: dict | None = None
        self.error: BaseException | None = None

    def outcome(self) -> dict:
        """The result of the run that filled this item, or its error raised."""
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result


class _PendingImagine(_Pending):
    """An /imagine request: its start state and action plan."""

    def __init__(self, state, actions, seed: int, decode: bool, raw: bool):
        super().__init__(seed, decode, raw)
        self.state = state
        self.actions = actions


class _PendingObserve(_Pending):
    """An /observe request: its three streams."""

    def __init__(self, actions, audio, vision, seed: int, decode: bool, raw: bool):
        super().__init__(seed, decode, raw)
        self.actions = actions
        self.audio = audio
        self.vision = vision


class _ImagineBatcher:
    """Window-based request coalescer: a long-lived thread collects
    concurrent requests for up to ``window_ms`` (or ``max_batch`` of them),
    hands them to ``run_batch`` as one list and wakes each waiter when its
    slot is filled. Generic over the pending item (the /observe coalescer
    is one too)."""

    def __init__(self, run_batch, window_ms: float, max_batch: int):
        self._run_batch = run_batch
        self._window = window_ms / 1000.0
        self._max = max_batch
        self._q: list[_Pending] = []
        self._cv = threading.Condition()
        self._stop = False
        # The size of every batch run, in order (tests and tuning read it).
        self.batch_sizes: list[int] = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item: _Pending) -> dict:
        with self._cv:
            if self._stop:
                raise RuntimeError("the batcher is stopped")
            self._q.append(item)
            self._cv.notify_all()
        item.event.wait()
        return item.outcome()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait()
                if self._stop:
                    items, self._q = self._q, []
                else:
                    deadline = time.monotonic() + self._window
                    while len(self._q) < self._max:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or self._stop:
                            break
                        self._cv.wait(remaining)
                    items, self._q = self._q[:self._max], self._q[self._max:]
            if items:
                self.batch_sizes.append(len(items))
                try:
                    self._run_batch(items)
                except BaseException as e:  # noqa: BLE001 — every waiter must wake
                    for it in items:
                        if it.error is None and it.result is None:
                            it.error = e
                finally:
                    for it in items:
                        it.event.set()
            if self._stop and not self._q:
                return


class InferenceServer:
    """Serve a ``WorldModel`` over HTTP. ``port=0`` picks a free port
    (``.port`` after construction).

    ``batch_window_ms > 0`` coalesces concurrent requests of each route
    (module docstring); ``batch_max`` caps the requests of one device
    call."""

    def __init__(self, world_model: WorldModel, host: str = "127.0.0.1", port: int = 8000,
                 state_capacity: int = 64, batch_window_ms: float = 0.0, batch_max: int = 8):
        self.wm = world_model
        self.states = _StateStore(state_capacity)
        # Requests re-run alone after their coalesced call failed (both
        # batcher threads count).
        self.retries = 0
        self._retries_lock = threading.Lock()
        # One queue a route, so a burst of one cannot starve the other.
        self.batcher = (_ImagineBatcher(self._run_imagine_batch, batch_window_ms, batch_max)
                        if batch_window_ms > 0 else None)
        self.observe_batcher = (
            _ImagineBatcher(self._run_observe_batch, batch_window_ms, batch_max)
            if batch_window_ms > 0 else None)
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
            "retries": self.retries,
        }

    def _observe(self, req: dict, raw: bool = False) -> dict:
        item = _PendingObserve(np.asarray(req["actions"], np.float32),
                               np.asarray(req["audio"], np.float32),
                               np.asarray(req["vision"], np.float32),
                               int(req.get("seed", 0)), bool(req.get("decode", False)), raw)
        return self._submit(self.observe_batcher, self._run_observe_batch, item)

    def _imagine(self, req: dict, raw: bool = False) -> dict:
        state = self.states.get(str(req["state_id"]))
        if state is None:
            raise UnknownStateError(str(req["state_id"]))
        item = _PendingImagine(state, np.asarray(req["actions"], np.float32),
                               int(req.get("seed", 0)), bool(req.get("decode", True)), raw)
        return self._submit(self.batcher, self._run_imagine_batch, item)

    @staticmethod
    def _submit(batcher, run_batch, item: _Pending) -> dict:
        """Through the route's batcher, or (window 0) at once as a batch of
        one on the calling thread."""
        if batcher is not None:
            return batcher.submit(item)
        run_batch([item])
        return item.outcome()

    # ---- batches -------------------------------------------------------------
    def _run_batch(self, items: list, run) -> None:
        """Run ``items`` through ``run(items)``, which fills each item's
        result, and deliver any failure to the items' errors. If a call of
        several fails, each item is re-run alone (``retries``), so that a
        malformed request fails by itself."""
        if len(items) > 1:
            try:
                run(items)
                return
            except Exception:  # noqa: BLE001 — each request is re-run alone below
                with self._retries_lock:
                    self.retries += len(items)
        for it in items:
            try:
                run([it])
            except Exception as e:  # noqa: BLE001 — delivered to its waiter
                it.error = e

    def _run_observe_batch(self, items: list[_PendingObserve]) -> None:
        self._run_batch(items, self._observe_batch)

    def _observe_batch(self, items: list[_PendingObserve]) -> None:
        """One device call for N /observe requests (``WorldModel.observe_many``):
        each request's state is its rows' posterior at its last step, its
        frames its rows and steps of the decoded batch. States are stored
        only once the whole call has succeeded."""
        decoded = None
        with self._device_lock:
            posterior, _ = self.wm.observe_many(
                [(it.actions, it.audio, it.vision, it.seed) for it in items])
            layout = _layout(items)
            finals = [posterior[o:o + b, t - 1].clone() for o, b, t in layout]
            if any(it.decode for it in items):
                decoded = self.wm.decode(posterior)
        frames = _slice_frames(items, decoded, layout)
        for it, final, f, (_, b, t) in zip(items, finals, frames, layout):
            it.result = {"state_id": self.states.put(final), "batch": b, "t": t}
            if f is not None:
                it.result["recon"] = f

    def _run_imagine_batch(self, items: list[_PendingImagine]) -> None:
        self._run_batch(items, self._imagine_batch)

    def _imagine_batch(self, items: list[_PendingImagine]) -> None:
        """One rollout for N /imagine requests (``WorldModel.imagine_many``),
        sliced and stored as :meth:`_observe_batch` does."""
        decoded = None
        with self._device_lock:
            imagined = self.wm.imagine_many([(it.actions, it.state, it.seed) for it in items])
            layout = _layout(items)
            finals = [imagined[o:o + b, t - 1].clone() for o, b, t in layout]
            if any(it.decode for it in items):
                decoded = self.wm.decode(imagined)
        frames = _slice_frames(items, decoded, layout)
        for it, final, f, (_, _, t) in zip(items, finals, frames, layout):
            it.result = {"state_id": self.states.put(final), "t": t}
            if f is not None:
                it.result["frames"] = f

    # ---- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Serve in a daemon thread (returns immediately)."""
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        """Serve in the calling thread."""
        self.httpd.serve_forever()

    def stop(self) -> None:
        """Stop serving, close the socket and end the batcher threads."""
        if self._thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
        for batcher in (self.batcher, self.observe_batcher):
            if batcher is not None:
                batcher.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _layout(items: list) -> list[tuple[int, int, int]]:
    """Each item's row offset, batch and steps in its coalesced call."""
    bs = [int(it.actions.shape[0]) for it in items]
    offsets = np.cumsum([0, *bs[:-1]]).tolist()
    return [(o, b, int(it.actions.shape[1])) for o, b, it in zip(offsets, bs, items)]


def _slice_frames(items: list, decoded: dict | None,
                  layout: list[tuple[int, int, int]]) -> list[dict | None]:
    """Each item's rows and steps of the call's ``decoded`` frames (copied to
    the host once) as its response payload, or None if it did not ask."""
    if decoded is None:
        return [None] * len(items)
    host = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in decoded.items()}
    return [_frames_out({k: v[o:o + b, :t] for k, v in host.items()}, it.raw) if it.decode
            else None for it, (o, b, t) in zip(items, layout)]


def _frames_out(decoded: dict, raw: bool) -> dict:
    """Decoded frames → response payload: numpy (npz framing) or lists."""
    arrays = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)
              for k, v in decoded.items()}
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
    """CLI entry: serve the model of ``--config`` (a YAML config) with the
    weights of ``--checkpoint`` (a run's checkpoints directory) through
    ``WorldModel.from_checkpoint``; or, without ``--config``,
    ``MoPoEMRSSM(MRSSMConfig())`` or ``MoPoEMMTRSSM(MMTRSSMConfig())``
    (``--model``) with the weights of a Lightning ``.ckpt``
    (``--checkpoint``; ``scripts/export_torch_checkpoint.py`` writes one)
    or, without one, a seeded init."""
    import argparse

    import torch

    from multimodal_mtrssm_tpu_torch.models import MoPoEMMTRSSM, MoPoEMRSSM
    from multimodal_mtrssm_tpu_torch.train.weights import load_lightning_checkpoint

    families = {"mrssm": MoPoEMRSSM, "mmtrssm": MoPoEMMTRSSM}
    ap = argparse.ArgumentParser(prog="serve")
    ap.add_argument("--config", help="YAML experiment config; --checkpoint is then the run's "
                                     "checkpoints directory")
    ap.add_argument("--model", choices=sorted(families), default="mrssm",
                    help="without --config: the model family, at its reference config")
    ap.add_argument("--checkpoint", help="with --config: a run's checkpoints directory (best, "
                                         "else last); without: a Lightning .ckpt")
    ap.add_argument("--seed", type=int, default=0,
                    help="init seed when neither --config nor --checkpoint is given")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on; 'cpu' must be asked for explicitly")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="coalesce concurrent requests arriving within this window into one "
                         "device call (0: off); each keeps its exact result")
    ap.add_argument("--batch-max", type=int, default=8,
                    help="the most requests in one coalesced device call")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"serve: --device {args.device} but CUDA is not available; "
                         "pass --device cpu to serve on the CPU")

    if args.config:
        if not args.checkpoint:
            raise SystemExit("serve: --config needs --checkpoint, the run's checkpoints directory")
        wm = WorldModel.from_checkpoint(args.config, args.checkpoint, args.device)
    else:
        model = families[args.model]().init(torch.Generator().manual_seed(args.seed))
        if args.checkpoint:
            load_lightning_checkpoint(model, args.checkpoint)
        wm = WorldModel(model, args.device)
    # batch_max means nothing without a window.
    batching = ({"batch_window_ms": args.batch_window_ms, "batch_max": args.batch_max}
                if args.batch_window_ms > 0 else {})
    server = InferenceServer(wm, host=args.host, port=args.port, **batching)
    print(f"serving {type(wm.model).__name__} on http://{args.host}:{server.port} "
          "(/healthz /observe /imagine)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
