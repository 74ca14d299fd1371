"""Captured CUDA graphs: the port's counterpart of `jax.jit`.

The JAX package runs each hot function as one compiled device program per
static signature (`jax.jit`, a clip as one `lax.scan`).  On the card the
counterpart is a CUDA graph: the function's kernels, copies and fills,
captured once per signature and replayed with one launch, so the host no
longer issues each operation.  `GraphCache` keeps one graph per key: the
caller's static arguments (those JAX marks static) with the inputs' shapes,
dtypes and device.

For a new key the call runs once eagerly, on a side stream ordered after the
caller's, on the graph's own input buffers.  That run is the call's result (a
function that writes state in place, as the serving step writes its ring,
writes it once), and it builds the lazily cached device constants and takes
cuDNN's and cuBLAS's choices at these shapes outside the capture, so the
graph runs what the eager call ran.  Then the same call is captured
(`capture_error_mode="thread_local"`: a thread may capture while another
computes, as the input pipeline's prefetch thread runs the flow while the
main thread trains) and instantiated.  Later calls copy their inputs into
the graph's buffers (a host tensor through a pinned stage, so the copy does
not wait for the device) and replay the graph on the caller's current
stream.  Kernel launches are counted per replay (`cuda_warp.add_launches`):
a capture's record is keyed by its stream, so the launches autograd's
device thread makes into it (a backward's kernels) are counted too.

A training step is captured whole, as PyTorch's whole-network capture is:
forward, backward and the optimizer in one graph, with grad mode as the
caller set it.  The step sets each `.grad` to None first, so the capture
allocates the gradients from the graph's pool and the optimizer reads them
in the same graph.  Captures run one at a time in the process (a module
lock), so a thread's capture never overlaps another's: the training step's
on the main thread and the augmentation's or the flow's on the input
pipeline's thread.

A collective of an NCCL process group is captured as any other work: the
eager first call creates the communicator (NCCL makes it at its first
collective, which must not happen inside a capture), and the capture records
NCCL's side stream and its events into the graph, from autograd's device
thread too (BatchNorm's all-reduce in the backward).  Every rank must reach
each key at the same point, or one rank's capture meets another's eager call.

A graph's outputs are its own buffers: valid until the next call of that
key, so the caller copies out what it keeps first.  A capture or a replay
that fails raises; nothing carries on eagerly on CUDA tensors.  On the CPU
`fn` runs eagerly: the caller asked for the plain versions.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from stabnet_tpu_torch.ops import cuda_warp


def signature(key: Hashable, inputs: Sequence[torch.Tensor],
              device: torch.device) -> tuple:
    """The cache key of a call: `key` (the static arguments), the device the
    graph runs on and each input's shape and dtype (an input's own device,
    host or card, and its strides do not matter: it is copied in)."""
    return (key, torch.device(device),
            tuple((tuple(int(d) for d in x.shape), x.dtype) for x in inputs))


class PinnedStage:
    """A page-locked host buffer for one role of copy (a graph's input, a
    batch call's grays, colors or results), reused from copy to copy.

    It grows to the largest request it has seen and serves each request
    from a contiguous prefix, so in steady state nothing new is pinned.  A
    copy to the card from it is asynchronous: `upload` records an event
    after the copy, and the next request waits on it before handing the
    buffer out again.  A copy into it from the card (`Tensor.copy_` into a
    `view`) is synchronous and needs no event.
    """

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None   # flat uint8, made at first use
        self.copied: Optional[torch.cuda.Event] = None

    def view(self, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        """A contiguous (shape, dtype) prefix of the buffer, once the copy
        that last read it has run; valid until the next request."""
        if self.copied is not None:
            self.copied.synchronize()
        nbytes = math.prod(shape) * dtype.itemsize
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = None   # the smaller buffer goes back first
            self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self.buf[:nbytes].view(dtype).view(tuple(shape))

    def upload(self, x: torch.Tensor, dst: torch.Tensor) -> None:
        """Copy the host tensor `x` into the card's `dst` through the
        buffer, without waiting for the card."""
        host = self.view(x.shape, x.dtype)
        host.copy_(x)
        dst.copy_(host, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()


class CapturedGraph:
    """One key's graph, its input and output buffers and what it costs."""

    def __init__(self, inputs: List[torch.Tensor]):
        self.inputs = inputs
        self.stages = [PinnedStage() for _ in inputs]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.launches: Dict[object, int] = {}   # kernel wrapper -> launches per replay
        self.warmup_s = 0.0       # the eager first call, on the side stream
        self.capture_s = 0.0      # capture and instantiation
        self.pool_bytes = 0       # device memory reserved while capturing
        self.replays = 0

    def load(self, inputs: Sequence[torch.Tensor]) -> None:
        for i, (dst, x) in enumerate(zip(self.inputs, inputs)):
            if x.device.type == "cpu":
                self.stages[i].upload(x, dst)
            else:
                dst.copy_(x)


class GraphCache:
    """Captured graphs of one or more functions, one per signature.

    `shared_pool`: every graph of a device allocates from one memory pool,
    which is safe when the cache's graphs never run at once and each call's
    outputs are copied out before the next call (the serving engine's
    graphs); else each graph has a pool of its own.  `lock` serializes
    captures and replays; a caller that copies outputs out holds it across
    the call and the copy.
    """

    # One capture at a time in the process (see the module's docstring).
    _capturing = threading.Lock()

    def __init__(self, shared_pool: bool = False):
        self.shared_pool = shared_pool
        self.lock = threading.RLock()
        self._graphs: Dict[tuple, CapturedGraph] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._pools: Dict[torch.device, tuple] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def stats(self) -> List[dict]:
        """Per graph: its key, warm-up and capture seconds, pool bytes and
        replays so far."""
        return [{"key": sig[0], "shapes": [s for s, _ in sig[2]], "warmup_s": g.warmup_s,
                 "capture_s": g.capture_s, "pool_bytes": g.pool_bytes, "replays": g.replays}
                for sig, g in self._graphs.items()]

    def __call__(self, key: Hashable, fn: Callable[..., Sequence[torch.Tensor]],
                 inputs: Sequence[torch.Tensor], device) -> Tuple[torch.Tensor, ...]:
        """`fn(*inputs)` as a tuple of tensors: on a CUDA `device` the graph of
        (key, inputs' shapes and dtypes) replayed, captured at the key's first
        call; on the CPU `fn` itself.  `fn` must give the same computation for
        equal keys (it is called only at capture)."""
        device = torch.device(device)
        if device.type != "cuda":
            return tuple(fn(*inputs))
        sig = signature(key, inputs, device)
        with self.lock, torch.cuda.device(device):
            graph = self._graphs.get(sig)
            if graph is None:
                with GraphCache._capturing:
                    return self._capture(sig, fn, inputs, device)
            graph.load(inputs)
            graph.graph.replay()
            graph.replays += 1
            cuda_warp.add_launches(graph.launches)
            return graph.outputs

    def _capture(self, sig: tuple, fn, inputs: Sequence[torch.Tensor],
                 device: torch.device) -> Tuple[torch.Tensor, ...]:
        cur = torch.cuda.current_stream(device)
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        side = self._streams[device]
        with torch.inference_mode(False):
            static = [torch.empty(tuple(x.shape), dtype=x.dtype, device=device)
                      for x in inputs]
        captured = CapturedGraph(static)
        captured.load(inputs)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            result = tuple(fn(*static))
        torch.cuda.synchronize(device)
        captured.warmup_s = time.perf_counter() - t0
        pool = None
        if self.shared_pool:
            if device not in self._pools:
                self._pools[device] = torch.cuda.graph_pool_handle()
            pool = self._pools[device]
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with cuda_warp.recording_launches(side) as launches:
                with torch.cuda.graph(graph, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    reserved = torch.cuda.memory_reserved(device)
                    outputs = tuple(fn(*static))
                    captured.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        except RuntimeError as e:
            raise RuntimeError(f"capturing the CUDA graph of {sig[0]!r} failed (no eager "
                               f"fallback on the card): {e}") from e
        captured.capture_s = time.perf_counter() - t0
        captured.graph, captured.outputs, captured.launches = graph, outputs, launches
        self._graphs[sig] = captured
        cur.wait_stream(side)
        for t in result:
            t.record_stream(cur)   # made on the side stream, read on the caller's
        return result
