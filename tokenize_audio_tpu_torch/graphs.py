"""Per-shape CUDA graphs of one stage of an encode: the Mimi transformer
stack.

At the engine's batches such a stage launches many kernels of a few
microseconds each (the transformer's ~35 ops a layer), less than the host
takes to launch them, so the device waits on the host. A ``GraphCache``, handed to
the model's ``encode``, captures the stage (the same ops in the same
order, so the same numbers) once per input shape and replays it as one
launch. Nothing in it is either model's own: it captures any function of
one tensor.

Per key (shape, strides, dtype and device of the input, and the fp32
matmul mode, IEEE or TF32, which the capture bakes in), the first call
runs the body eagerly, which also does its lazy set-up (cuBLAS handles,
module loads), and captures it right after; capturing queues no device
work. Every later call copies the input into the graph's static input,
replays the graph and returns a copy of its static output, so a caller
holding an earlier result is never overwritten by a later replay. All
three are queued on the caller's current stream, ordered with its other
work; a lock keeps one thread's three together.

The graphs of one cache share one memory pool, which grows to the largest
shape's activations rather than their sum. Sharing is safe because every
replay's output is copied before anything else is queued: another graph
may reuse that memory for its own activations, never while it is read.
The pool and each shape's static input and output stay reserved until the
cache is dropped and the allocator's cache emptied
(``torch.cuda.empty_cache()``).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

# (body, static input) -> (replay, static output): what a capture returns
Capture = Callable[[Callable, torch.Tensor], tuple]


class GraphCache:
    """A cache of captured stages for one device, owned by the
    caller whose parameters stay at fixed addresses for the cache's life
    (the engine's). ``on_event("capture" | "replay")`` is called after
    each. ``capture`` replaces the CUDA capture (the tests drive the
    policy with a stand-in); without one the cache captures only on a CUDA
    device, and elsewhere every call runs eagerly."""

    def __init__(self, device, on_event: Optional[Callable[[str], None]] = None,
                 capture: Optional[Capture] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._on_event = on_event or (lambda kind: None)
        if capture is None and self.device.type == "cuda":
            capture = self._capture_cuda
        self._capture = capture
        self._graphs: dict = {}  # key -> (static input, replay, static output)
        self._lock = threading.Lock()
        self._pool = None
        self._stream = None

    def engages(self, h: torch.Tensor, group) -> bool:
        """Whether a call on ``h`` goes through the cache: it can capture,
        ``h`` is on its device, no tensor-parallel group sums inside the
        stack, and no gradient is recorded."""
        return (self._capture is not None and group is None and h.device == self.device
                and not torch.is_grad_enabled())

    def __call__(self, body: Callable[[torch.Tensor], torch.Tensor], h: torch.Tensor):
        """``body(h)``: eagerly and then captured the first time ``h``'s key
        is seen, replayed from the second."""
        key = (tuple(h.shape), h.stride(), h.dtype, h.device,
               torch.backends.cuda.matmul.allow_tf32)
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                out = body(h)
                static_in = torch.empty_strided(h.shape, h.stride(), dtype=h.dtype,
                                                device=h.device)
                self._graphs[key] = (static_in, *self._capture(body, static_in))
                kind = "capture"
            else:
                static_in, replay, static_out = entry
                static_in.copy_(h)
                replay()
                out = static_out.clone()
                kind = "replay"
        self._on_event(kind)
        return out

    def _capture_cuda(self, body, static_in):
        """``body`` on ``static_in`` captured on a side stream into the
        cache's pool. The capture is thread-local, so another thread's
        calls (a fetch thread's event wait) run on while it is open."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                static_out = body(static_in)
            finally:
                graph.capture_end()
        return graph.replay, static_out
