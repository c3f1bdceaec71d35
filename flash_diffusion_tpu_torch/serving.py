"""Serving layer of the port: dynamic batching and an HTTP inference server.

Port of ``flash_diffusion_tpu/serving.py``:

- ``DynamicBatcher``: a linger-window request coalescer on one worker
  thread. Requests with the same (steps, guidance, height, width,
  has-negative) key merge up to ``max_batch``, padded to the smallest of
  ``batch_sizes`` that holds them (a fixed set of batch shapes; on the card
  it bounds the shapes the kernels and cuDNN see). Key mismatches pulled
  while lingering wait first in line for the next batch. Each request's
  seed goes through as a per-sample seed, so its latent and every step's
  noise depend on that seed alone. Its image is the same batched, padded or
  alone up to the batch-size-dependent algorithms of cuDNN and cuBLAS (the
  contract of ``FlashPipeline.generate``: on an H100 an SDXL request at
  128² alone and in slot 1 of a batch of 4 differ by 9.2e-3 rel. L2 in
  bf16, 9.8e-3 in int8, against 1.3 for another seed). Occupancy
  counters: images / padded slots.
- ``InferenceServer``: a stdlib ``ThreadingHTTPServer`` front end:
  ``POST /generate`` (PNG, or base64 PNGs in JSON), ``GET /healthz``,
  ``GET /metrics`` (counters, latency quantiles), ``GET``/``POST /loras``
  (list / load / scale / unload adapters at run time) and ``POST /profile``
  (a ``torch.profiler`` trace of live traffic into a directory).

Images leave the card as uint8 (``_device_uint8``), 4× fewer bytes than
fp32, and are encoded with the port's stdlib PNG writer
(``sample.png_bytes``). One process, one pipeline; scale-out is replicas
behind a load balancer.

Tensor-parallel serving (``serve.py --tp N``; JAX ``examples/serve.py:
72-118``): every rank holds its shard of one pipeline
(``FlashPipeline.shard_tp``). Rank 0 runs the HTTP front end and the
batcher over a ``TPPipeline``, which sends each command that touches the
weights or the group over one ordered channel (``TPChannel``, a broadcast
from rank 0) before running it itself: a dispatch's spec (the
pre-tokenized batch that ``generate`` takes, seeds, steps, guidance,
height, width) and every ``/loras`` change, so that all ranks run the same
``generate`` calls in lockstep and swap weights at the same dispatch
boundary. The followers run ``TPChannel.follow`` and skip the decode.
While idle rank 0 sends a no-op every few seconds, within the group's
timeout. An error in a dispatch leaves the ranks out of step: the
batcher's error boundary then stops the server (``InferenceServer.fatal``)
and ``serve.py`` exits non-zero; a follower's error ends its process, and
rank 0's next collective (a heartbeat while idle) fails within the group's
timeout and stops the server too. A ``/loras`` change that fails on some
ranks only stops it at once; one that fails on every rank alike (a bad
file) leaves the weights as they were and the server up. ``/profile``,
``/metrics`` and ``/healthz`` are rank 0's.
"""

from __future__ import annotations

import base64
import collections
import json
import os
import queue
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .parallel.mesh import DEFAULT_TIMEOUT_S, broadcast_object, rank, world_size
from .sample import png_bytes


@dataclass
class ServingConfig:
    host: str = "127.0.0.1"
    port: int = 8500  # 0: any free port (``InferenceServer.address`` once bound)
    max_batch: int = 8
    # how long the batcher waits for more requests once it holds one (ms)
    linger_ms: float = 10.0
    default_steps: int = 4
    default_guidance: float = 0.0
    # batch shapes: a coalesced batch is padded to the smallest that holds it
    batch_sizes: tuple = (1, 4, 8)
    # run every batch size once at the defaults before serving
    prewarm: bool = False
    # images leave the card as uint8 [H, W, 3]; False keeps the float
    # [-1, 1] images on the request (bit-exactness tests)
    uint8_images: bool = True


@dataclass
class _Request:
    prompt: str
    seed: int
    steps: int
    guidance: float
    height: Optional[int] = None  # None: the pipeline's default resolution
    width: Optional[int] = None
    negative: Optional[str] = None  # consulted only when guidance enables CFG
    event: threading.Event = field(default_factory=threading.Event)
    image: Optional[np.ndarray] = None
    error: Optional[str] = None


class DynamicBatcher:
    """Coalesces generate requests into fixed-shape pipeline dispatches.
    ``on_fatal``: None, or a callable that a dispatch error is handed to
    after its callers are told, when the pipeline cannot go on after one
    (a ``TPPipeline``)."""

    def __init__(self, pipeline, config: ServingConfig):
        self.pipeline = pipeline
        self.config = config
        self.on_fatal = None
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # key mismatches pulled while lingering: first in line next time, so
        # a stream of another key's traffic cannot starve them
        self._deferred: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self.batches_dispatched = 0
        self.images_generated = 0
        self.slots_dispatched = 0  # padded slots (the occupancy denominator)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        """Stop the worker; a dispatch in flight finishes first (up to 30 s)."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)

    def submit(self, prompt: str, seed: int, steps: int, guidance: float,
               height: Optional[int] = None, width: Optional[int] = None,
               negative: Optional[str] = None) -> _Request:
        req = _Request(prompt=prompt, seed=seed, steps=steps, guidance=guidance,
                       height=height, width=width, negative=negative)
        self._queue.put(req)
        return req

    @staticmethod
    def _key(r: _Request):
        # steps/guidance change the sampler, height/width every shape; the
        # negative flag keeps a request's uncond mode (ucg-zeroed vs encoded
        # negative text) independent of what else is in flight
        return (r.steps, r.guidance, r.height, r.width, bool(r.negative))

    def _take_batch(self) -> List[_Request]:
        if self._deferred:
            first = self._deferred.popleft()
        else:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return []
        batch = [first]
        key = self._key(first)
        deadline = time.monotonic() + self.config.linger_ms / 1000.0
        while self._deferred and len(batch) < self.config.max_batch:
            if self._key(self._deferred[0]) != key:
                break
            batch.append(self._deferred.popleft())
        while len(batch) < self.config.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if self._key(nxt) == key:
                batch.append(nxt)
            else:
                self._deferred.append(nxt)
                break
        return batch

    def _compile_size(self, n: int) -> int:
        for s in sorted(self.config.batch_sizes):
            if s >= n:
                return s
        return max(self.config.batch_sizes)

    def _worker(self):
        while not self._stop.is_set():
            batch = self._take_batch()
            if batch:
                self._dispatch(batch)

    def _dispatch(self, batch: List[_Request]) -> None:
        try:
            n = len(batch)
            size = self._compile_size(n)
            negatives = None
            if any(r.negative for r in batch) and batch[0].guidance not in (0.0, 1.0):
                negatives = [r.negative or "" for r in batch] + [""] * (size - n)
            images = self.pipeline.generate(
                [r.prompt for r in batch] + [""] * (size - n),
                num_inference_steps=batch[0].steps,
                guidance_scale=batch[0].guidance,
                negative_prompts=negatives,
                seed=[r.seed for r in batch] + [0] * (size - n),
                height=batch[0].height,
                width=batch[0].width,
            )[:n]
            if self.config.uint8_images:
                images = _device_uint8(images)
            images = images.cpu().numpy()
            # counted before any caller wakes, so its /metrics include it
            self.batches_dispatched += 1
            self.images_generated += n
            self.slots_dispatched += size
            for r, img in zip(batch, images):
                r.image = img
                r.event.set()
        except Exception as e:  # the boundary that keeps serving: report to every caller
            for r in batch:
                r.error = f"{type(e).__name__}: {e}"
                r.event.set()
            if getattr(self.pipeline, "fatal_errors", False) and self.on_fatal is not None:
                self.on_fatal(e)  # the tensor-parallel ranks are out of step: stop serving


def _device_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float → uint8 on the images' device (truncating, as the JAX
    ``astype(uint8)`` and ``_to_png_bytes`` on the host)."""
    return ((images.float() + 1.0) * 127.5).clamp(0.0, 255.0).to(torch.uint8)


def _to_png_bytes(image: np.ndarray) -> bytes:
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip((arr.astype(np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return png_bytes(arr)


def _all_threads():
    """The profiler's setting that records every thread's ops, not only the
    caller's (the batcher runs ``generate`` on its own thread), where this
    PyTorch has it; else None."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


class InferenceServer:
    """HTTP front end over a FlashPipeline and a DynamicBatcher."""

    def __init__(self, pipeline, config: Optional[ServingConfig] = None):
        self.config = config or ServingConfig()
        self.batcher = DynamicBatcher(pipeline, self.config)
        self._latencies: List[float] = []
        self._lock = threading.Lock()  # the counters and latencies
        self.requests = 0
        self.errors = 0
        self._httpd: Optional[ThreadingHTTPServer] = None
        self.ready = threading.Event()  # set once the socket is bound
        self.address = None  # (host, port) once bound
        self.fatal: Optional[BaseException] = None  # the error that stopped a tensor-parallel server
        self.batcher.on_fatal = self._stop_on

    def _stop_on(self, error: BaseException) -> None:
        """Stop serving after ``error`` (from the batcher's, an HTTP
        handler's or the heartbeat's thread); the first error is kept."""
        if self.fatal is None:
            self.fatal = error
        self.batcher._stop.set()
        if self._httpd is not None:
            threading.Thread(target=self._httpd.shutdown, daemon=True).start()

    def _count(self, errors: int = 0, latency: Optional[float] = None) -> None:
        with self._lock:
            self.errors += errors
            if latency is not None:
                self._latencies.append(latency)
                del self._latencies[:-512]

    # ---- request handling (transport-independent, testable) ----
    def handle_generate(self, body: Dict[str, Any], timeout: float = 600.0) -> Dict[str, Any]:
        prompts = body.get("prompt", "")
        if isinstance(prompts, str):
            prompts = [prompts]
        if not prompts:
            return {"error": "empty prompt list", "code": 400}
        steps = int(body.get("steps", self.config.default_steps))
        guidance = float(body.get("guidance_scale", self.config.default_guidance))
        seed = int(body.get("seed", 0))
        height, width = body.get("height"), body.get("width")
        if (height is None) != (width is None):
            return {"error": "pass both height and width, or neither", "code": 400}
        if height is not None:
            height, width = int(height), int(width)
            align = 8 * self.batcher.pipeline.vae_scale_factor
            if height <= 0 or width <= 0 or height % align or width % align:
                return {"error": f"height/width must be positive multiples of {align}", "code": 400}
        negative = body.get("negative_prompt")
        t0 = time.monotonic()
        with self._lock:
            self.requests += 1
        reqs = [self.batcher.submit(p, seed + i, steps, guidance, height, width, negative)
                for i, p in enumerate(prompts)]
        for r in reqs:
            if not r.event.wait(timeout):
                self._count(errors=1)
                return {"error": "timeout"}
        errs = [r.error for r in reqs if r.error]
        if errs:
            self._count(errors=1)
            return {"error": errs[0]}
        dt = time.monotonic() - t0
        self._count(latency=dt)
        return {"images": [r.image for r in reqs], "latency_s": dt}

    def handle_loras(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """List / load / rescale / unload LoRA adapters without a restart. A
        dispatch in flight finishes with the weights it started with; later
        ones see the new merge (``FlashPipeline._refresh``)."""
        pipe = self.batcher.pipeline
        action = body.get("action", "list")
        try:
            if action == "load":
                pipe.load_lora_file(body["path"], float(body.get("scale", 1.0)), body.get("name", "default"))
            elif action == "scale":
                pipe.set_adapter_scale(body["name"], float(body["scale"]))
            elif action == "unload":
                pipe.unload_lora(body.get("name", "default"))
            elif action != "list":
                return {"error": f"unknown action {action!r}", "code": 400}
        except KeyError as e:
            return {"error": f"missing field {e}", "code": 400}
        except Exception as e:  # a bad file or adapter: report it, keep serving
            return {"error": f"{type(e).__name__}: {e}", "code": 400}
        return {"adapters": pipe.adapters}

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            lats = sorted(self._latencies)
            requests, errors = self.requests, self.errors
        q = lambda p: round(lats[min(len(lats) - 1, int(p * len(lats)))], 4) if lats else None
        b = self.batcher
        return {
            "requests": requests,
            "errors": errors,
            "images_generated": b.images_generated,
            "batches_dispatched": b.batches_dispatched,
            # real images / padded slots: low occupancy means the linger
            # window or the batch_sizes ladder needs tuning
            "batch_occupancy": round(b.images_generated / b.slots_dispatched, 3)
            if b.slots_dispatched else None,
            "latency_p50_s": q(0.50),
            "latency_p95_s": q(0.95),
        }

    def handle_profile(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """A ``torch.profiler`` trace (host ops of every thread, the
        batcher's with its ``fdt.*`` stage spans, and the card's kernels on
        CUDA) of live traffic: POST /profile {"seconds": 5, "dir": ...}
        blocks for the window and writes ``trace.json`` into the directory,
        which ``trace_top.py --parse`` ranks."""
        seconds = float(body.get("seconds", 5.0))
        out_dir = body.get("dir") or os.path.join(tempfile.gettempdir(), "flash_serve_trace")
        if seconds <= 0 or seconds > 120:
            return {"error": "seconds must be in (0, 120]", "code": 400}
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.batcher.pipeline.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            os.makedirs(out_dir, exist_ok=True)
            with torch.profiler.profile(activities=activities, experimental_config=_all_threads()) as prof:
                time.sleep(seconds)
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        except (OSError, RuntimeError) as e:
            return {"error": f"{type(e).__name__}: {e}", "code": 500}
        return {"trace_dir": out_dir, "seconds": seconds}

    def prewarm(self) -> None:
        """Run every configured batch size once at the default (steps,
        guidance), so the first request finds kernels built and cuDNN's
        algorithm choices made."""
        pipe = self.batcher.pipeline
        for size in sorted(self.config.batch_sizes):
            t0 = time.monotonic()
            pipe.generate([""] * size, num_inference_steps=self.config.default_steps,
                          guidance_scale=self.config.default_guidance, seed=list(range(size)))
            print(f"prewarm: batch {size} ready in {time.monotonic() - t0:.1f}s", flush=True)

    def healthz(self) -> Dict[str, Any]:
        device = self.batcher.pipeline.device
        return {
            "ok": True,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
            "devices": torch.cuda.device_count() if device.type == "cuda" else 1,
            "max_batch": self.config.max_batch,
        }

    # ---- transport ----
    def serve_forever(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, data: bytes, content_type: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_json(self, obj, code=200):
                self._send(json.dumps(obj).encode(), "application/json", code)

            def _send_result(self, result):
                self._send_json(result, result.pop("code", 500) if "error" in result else 200)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send_json(server.healthz())
                elif self.path == "/metrics":
                    self._send_json(server.metrics())
                elif self.path == "/loras":
                    self._send_json(server.handle_loras({}))
                else:
                    self._send_json({"error": "not found"}, 404)

            def do_POST(self):
                if self.path not in ("/generate", "/loras", "/profile"):
                    self._send_json({"error": "not found"}, 404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, OSError) as e:
                    self._send_json({"error": f"bad request: {e}"}, 400)
                    return
                if self.path == "/loras":
                    self._send_result(server.handle_loras(body))
                    return
                if self.path == "/profile":
                    self._send_result(server.handle_profile(body))
                    return
                result = server.handle_generate(body)
                if "error" in result:
                    self._send_result(result)
                    return
                pngs = [_to_png_bytes(img) for img in result["images"]]
                if body.get("format", "png") == "json":
                    self._send_json({"images_png_b64": [base64.b64encode(p).decode() for p in pngs],
                                     "latency_s": result["latency_s"]})
                else:
                    self._send(pngs[0], "image/png")

        if self.config.prewarm:
            self.prewarm()
        self.batcher.start()
        self._httpd = ThreadingHTTPServer((self.config.host, self.config.port), Handler)
        self.address = self._httpd.server_address[:2]
        self.ready.set()
        try:
            if self.fatal is None:  # else stopped while starting (``_stop_on`` found no socket)
                self._httpd.serve_forever()
        finally:
            self._httpd.server_close()
            self.batcher.stop()

    def shutdown(self):
        """Stop ``serve_forever`` (from another thread) and its batcher."""
        if self._httpd is not None:
            self._httpd.shutdown()
        self.batcher.stop()


# ---------------------------------------------------------------- tensor parallel
class OutOfStep(RuntimeError):
    """A command that failed on some ranks of a tensor-parallel group only."""


class TPChannel:
    """The ordered command channel of a tensor-parallel server: rank 0's
    ``send`` broadcasts a command to the group and runs it itself, under one
    lock, so that commands (and the collectives they make) never overlap;
    the followers' ``follow`` runs each in the order sent. A command is
    (name, keyword arguments) of ``COMMANDS``. After a ``/loras`` command
    the ranks compare their outcomes: one that failed on some ranks only
    raises on all. While idle, rank 0 sends a no-op every ``heartbeat_s``
    seconds, so that a follower's wait stays within the group's timeout.
    A command out of step, or a broadcast that fails (a lost rank), closes
    the channel and is handed to ``on_fatal`` (rank 0's server stops)."""

    COMMANDS = ("generate", "load_lora_file", "set_adapter_scale", "unload_lora", "noop", "stop")

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.lock = threading.Lock()
        self.heartbeat_s = DEFAULT_TIMEOUT_S / 6
        self._last = time.monotonic()
        self._closed = threading.Event()
        self._beat = None
        self.on_fatal = None

    def start(self):
        """Rank 0: start the heartbeat."""
        self._beat = threading.Thread(target=self._heartbeat, daemon=True)
        self._beat.start()
        return self

    def _heartbeat(self):
        while not self._closed.wait(self.heartbeat_s / 4):
            if time.monotonic() - self._last >= self.heartbeat_s and self.lock.acquire(blocking=False):
                try:
                    if not self._closed.is_set():
                        self._broadcast(("noop", {}))
                except Exception as e:  # the group is broken
                    self._fail(e)
                    return
                finally:
                    self.lock.release()

    def _fail(self, error: BaseException) -> None:
        """The ranks are out of step or the group is broken: no command
        goes out any more, and rank 0's server stops."""
        self._closed.set()
        if self.on_fatal is not None:
            self.on_fatal(error)

    def _broadcast(self, cmd):
        out = broadcast_object(cmd)
        self._last = time.monotonic()
        return out

    def _run(self, command: str, kw: Dict[str, Any]):
        pipe = self.pipeline
        if command == "generate":
            return pipe.generate(**kw)
        if command in ("noop", "stop"):
            return None
        error = None
        try:
            getattr(pipe, command)(**kw)
        except Exception as e:  # the same bad file on every rank leaves the weights as they were
            error = e
        outcomes = [None] * world_size()
        dist.all_gather_object(outcomes, error is None)
        if len(set(outcomes)) > 1:
            raise OutOfStep(f"{command} failed on some ranks only ({outcomes}): the ranks' weights differ")
        if error is not None:
            raise error

    def send(self, command: str, **kw):
        """Rank 0: broadcast the command, then run it here."""
        if command not in self.COMMANDS:
            raise ValueError(command)
        with self.lock:
            if self._closed.is_set():
                raise RuntimeError("the tensor-parallel channel is closed")
            try:
                self._broadcast((command, kw))
            except Exception as e:
                self._fail(e)
                raise
            if command == "stop":
                self._closed.set()
            try:
                return self._run(command, kw)
            except OutOfStep as e:
                self._fail(e)
                raise

    def follow(self) -> None:
        """A follower: run rank 0's commands until ``stop``. Errors of a
        ``generate`` propagate (the process ends); a ``/loras`` command that
        failed on every rank is left as it is, as on rank 0."""
        while True:
            command, kw = self._broadcast(None)
            if command == "stop":
                return
            if command == "generate":
                self._run(command, {**kw, "decode": False})  # rank 0 alone decodes
                continue
            try:
                self._run(command, kw)
            except OutOfStep:
                raise
            except Exception:  # failed alike on rank 0, which reports it
                pass

    def close(self) -> None:
        """Rank 0: tell the followers to stop (once)."""
        if not self._closed.is_set():
            self.send("stop")
        self._closed.set()


class TPPipeline:
    """Rank 0's view of a tensor-parallel ``FlashPipeline`` for the server:
    ``generate`` (prompts pre-tokenized here) and the adapter changes go
    through the ``TPChannel``; every other attribute is the pipeline's."""

    fatal_errors = True  # an error in a dispatch leaves the ranks out of step

    def __init__(self, pipeline, channel: TPChannel):
        self._pipe, self.channel = pipeline, channel

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate(self, prompts, num_inference_steps: int = 4, guidance_scale: float = 0.0,
                 negative_prompts=None, seed=0, height=None, width=None):
        if not isinstance(prompts, dict):
            prompts = self._pipe.encode_prompts(prompts, height, width)
        seed = [int(s) for s in seed] if isinstance(seed, (list, tuple, np.ndarray)) else int(seed)
        return self.channel.send("generate", prompts=prompts, num_inference_steps=num_inference_steps,
                                 guidance_scale=guidance_scale, negative_prompts=negative_prompts, seed=seed,
                                 height=height, width=width)

    def load_lora_file(self, path: str, scale: float = 1.0, name: str = "default"):
        self.channel.send("load_lora_file", path=path, scale=scale, name=name)

    def set_adapter_scale(self, name: str, scaling: float):
        self.channel.send("set_adapter_scale", name=name, scaling=scaling)

    def unload_lora(self, name: str = "default"):
        self.channel.send("unload_lora", name=name)


def serve_tp_rank(pipeline, config: ServingConfig, on_ready=None) -> Optional["InferenceServer"]:
    """Run one rank of a tensor-parallel server over a pipeline already
    placed with ``shard_tp`` over the default group: rank 0 serves HTTP until shut down
    (``on_ready(server)`` is called from a thread once the socket is bound,
    e.g. to drive it) and then stops the followers; the others follow.
    Returns rank 0's server. Raises on rank 0 when the server stopped on an
    error (``InferenceServer.fatal``): a dispatch that raised, a ``/loras``
    change that failed on some ranks only, a heartbeat that failed."""
    channel = TPChannel(pipeline)
    if rank() != 0:
        channel.follow()
        return None
    server = InferenceServer(TPPipeline(pipeline, channel), config)
    channel.on_fatal = server._stop_on
    channel.start()
    errors = []
    if on_ready is not None:
        def drive():
            server.ready.wait()
            try:
                on_ready(server)
            except BaseException as e:  # re-raised below, on the serving thread
                errors.append(e)
            finally:
                server.shutdown()
        threading.Thread(target=drive, daemon=True).start()
    try:
        server.serve_forever()
    finally:
        if server.fatal is None:  # after a fatal error the followers are out of step: no stop to send
            channel.close()
    if errors:
        raise errors[0]
    if server.fatal is not None:
        raise RuntimeError(f"the tensor-parallel server stopped: {server.fatal!r}") from server.fatal
    return server
