"""Dispatch-argument packing and the captured step (port of
aefs_tpu/core/packing.py).

In the JAX package ``Packer`` flattens a state tree into one 1-D buffer
per dtype, so a jitted dispatch marshals a few buffers instead of ~50,
and ``PackedRunner`` jits ``unpack -> fn -> repack`` with the packed state
donated.  On the card the counterpart of that one compiled dispatch is a
CUDA graph: ``PackedRunner`` owns static device buffers for the packed
state, the packed targets, the input block ``x`` and the output ``y``,
captures ``unpack -> fn -> repack into the same state buffers`` once as
one ``torch.cuda.CUDAGraph`` and replays it for every block, so a step of
hundreds of eager launches becomes one graph launch.  A step whose static
buffers span cards (a mesh row's model axis, ``parallel/mesh.py``) is one
graph across them.

The groups are JAX's: leaves in ``jax.tree.flatten`` order
(``core/convert.py:flatten_like_jax``), one flat buffer per dtype in the
order the dtypes first appear; ``HybridPacker`` keeps every leaf over
``big_bytes`` as a buffer of its own, those first.  Groups cross packages
as numpy arrays both ways.

On the CPU the same runner runs ``fn`` eagerly over the same static
buffers with the same in-place update: that is how the CPU tests reach
this logic.  ``Staging`` carries host blocks into a runner's static
buffers through pinned memory.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from aefs_tpu_torch.core.convert import flatten_like_jax, unflatten_like_jax
from aefs_tpu_torch.models.base import tree_map
from aefs_tpu_torch.utils.metrics import TRACER

# torch has few kernels for unsigned types: their groups are joined as the
# signed type of the same width (the ring mod's and bitcrusher's uint32
# phase accumulators).
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}

# One capture at a time per process: a capture stream per card, and the
# warm-up and capture of one runner never interleave with another's.
_capture_lock = threading.Lock()
_capture_streams = {}

# Dummy steps on silence before a capture (kernel loading, cuFFT plans, the
# kernel library's first-use build), as the JAX package's warm-up runs two.
WARM_STEPS = 2


def _skeleton(tree):
    """``tree``'s structure with every leaf None (``unflatten_like_jax``
    fills it): a packer keeps no reference to its example's tensors."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_skeleton(v) for v in tree)
    return None


def _cat(parts, dtype):
    """One new 1-D tensor of ``parts`` in order: always a copy, even of a
    single part, so it never aliases a leaf."""
    signed = _SIGNED.get(dtype)
    if signed is None:
        return torch.cat(parts)
    return torch.cat([p.view(signed) for p in parts]).view(dtype)


def _leaves(packer, tree):
    leaves = flatten_like_jax(tree)
    if len(leaves) != packer.n_leaves:
        raise ValueError(f"the tree has {len(leaves)} leaves; the packer was built "
                         f"for {packer.n_leaves}")
    return leaves


def _size(shape):
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


class Packer:
    """Flatten/unflatten a fixed-structure tree to one 1-D tensor per
    dtype.  The structure (keys, shapes, dtypes) is taken from an example
    at construction and must match every later call."""

    def __init__(self, example):
        leaves = flatten_like_jax(example)
        self.skeleton = _skeleton(example)
        self.metas = []  # (dtype, shape, size, group_index, offset)
        self.dtypes = []
        offsets = {}
        for leaf in leaves:
            dt, shape = leaf.dtype, tuple(leaf.shape)
            if dt not in offsets:
                offsets[dt] = 0
                self.dtypes.append(dt)
            self.metas.append((dt, shape, _size(shape), self.dtypes.index(dt), offsets[dt]))
            offsets[dt] += _size(shape)
        self.group_sizes = tuple(offsets[dt] for dt in self.dtypes)

    @property
    def n_leaves(self):
        return len(self.metas)

    @property
    def n_groups(self):
        return len(self.dtypes)

    def pack(self, tree):
        """tree -> tuple of new 1-D tensors, one per dtype."""
        parts = [[] for _ in self.dtypes]
        for leaf, (dt, shape, size, gi, _) in zip(_leaves(self, tree), self.metas):
            if leaf.numel() != size:
                raise ValueError(f"a leaf of shape {tuple(leaf.shape)} where the packer "
                                 f"holds {shape}")
            parts[gi].append(leaf.to(dt).reshape(-1))
        return tuple(_cat(p, dt) for p, dt in zip(parts, self.dtypes))

    def unpack(self, groups):
        """tuple of 1-D tensors -> tree of views into them."""
        leaves = [groups[gi][off:off + size].view(shape)
                  for dt, shape, size, gi, off in self.metas]
        return unflatten_like_jax(self.skeleton, leaves)


class HybridPacker:
    """Size-thresholded packing: leaves BIGGER than ``big_bytes`` stay
    buffers of their own (repacking them would copy megabytes per step);
    smaller leaves pack into one 1-D tensor per dtype and device (a mesh
    row's model-axis parts live on their own cards; on one device this is
    JAX's one group per dtype).  Group order: the big leaves, then the
    small groups in the order their (dtype, device) first appears."""

    def __init__(self, example, big_bytes=131072):
        leaves = flatten_like_jax(example)
        self.skeleton = _skeleton(example)
        # ("big", index, shape, dtype) or ("small", group, shape, dtype, offset, size)
        self.routes = []
        self.n_big = 0
        self.small_keys = []  # (dtype, device) of each small group
        offsets = {}
        for leaf in leaves:
            dt, shape = leaf.dtype, tuple(leaf.shape)
            size = _size(shape)
            if size * leaf.element_size() > big_bytes:
                self.routes.append(("big", self.n_big, shape, dt))
                self.n_big += 1
            else:
                key = (dt, leaf.device)
                if key not in offsets:
                    offsets[key] = 0
                    self.small_keys.append(key)
                gi = self.small_keys.index(key)
                self.routes.append(("small", gi, shape, dt, offsets[key], size))
                offsets[key] += size
        self.group_sizes = tuple(offsets[key] for key in self.small_keys)

    @property
    def n_leaves(self):
        return len(self.routes)

    @property
    def n_groups(self):
        return self.n_big + len(self.small_keys)

    def pack(self, tree):
        """tree -> tuple: the big leaves themselves, then one new 1-D
        tensor per small (dtype, device)."""
        bigs = [None] * self.n_big
        smalls = [[] for _ in self.small_keys]
        for leaf, route in zip(_leaves(self, tree), self.routes):
            if tuple(leaf.shape) != route[2]:
                raise ValueError(f"a leaf of shape {tuple(leaf.shape)} where the packer "
                                 f"holds {route[2]}")
            if route[0] == "big":
                bigs[route[1]] = leaf.to(route[3])
            else:
                smalls[route[1]].append(leaf.to(route[3]).reshape(-1))
        return tuple(bigs) + tuple(_cat(p, dt) for p, (dt, _) in zip(smalls, self.small_keys))

    def unpack(self, groups):
        """groups -> tree: the big groups themselves, views of the rest."""
        leaves = []
        for route in self.routes:
            if route[0] == "big":
                leaves.append(groups[route[1]])
            else:
                _, gi, shape, _dt, off, size = route
                leaves.append(groups[self.n_big + gi][off:off + size].view(shape))
        return unflatten_like_jax(self.skeleton, leaves)


def _storage(t):
    return t.untyped_storage().data_ptr()


def capture_stream(device):
    """The stream graphs of ``device`` are warmed up and captured on."""
    key = torch.device(device).index
    if key not in _capture_streams:
        _capture_streams[key] = torch.cuda.Stream(device=device)
    return _capture_streams[key]


def _side_pool(device):
    """A private memory pool on the side card ``device`` for a graph to
    keep (``graph.side_pools``).  A ``MemPool`` registers with the current
    card's allocator and holds its pool there until it is dropped; one made
    under another card would leave the side card's pool to
    ``use_mem_pool``'s own reference alone, which its exit drops, and the
    next ``empty_cache`` (every capture calls one) would free memory the
    graph's nodes still use."""
    with torch.cuda.device(device):
        return torch.cuda.MemPool()


@contextlib.contextmanager
def _with_sides(device, stream, sides, pools=None):
    """Run a step issued on ``stream`` (``device``'s) with each side card's
    work on that card's capture stream: forked from ``stream`` on entry and
    joined back into it on exit.  Inside a capture the fork makes the side
    streams join the capture, so the side cards' kernels and the copies
    between cards become nodes of the one graph, ordered by the events the
    cross-card copies record; ``pools`` (one ``torch.cuda.MemPool`` per
    side) then hold the side cards' intermediates, which the graph keeps
    using after the capture, away from every other allocation.  ``device``
    stays current."""
    with contextlib.ExitStack() as stack:
        for k, side in enumerate(sides):
            side.wait_stream(stream)
            stack.enter_context(torch.cuda.stream(side))
            if pools is not None:
                stack.enter_context(torch.cuda.use_mem_pool(pools[k], device=side.device))
        stack.enter_context(torch.cuda.device(device))
        yield
        for side in sides:
            stream.wait_stream(side)


class PackedRunner:
    """``fn(state, targets, x) -> (state, y)`` over packed groups, with JAX's
    methods: ``pack_state``, ``unpack_state``, ``pack_targets`` and
    ``runner(sgroups, tgroups, x) -> (sgroups, y)``.

    The runner owns static buffers: the state groups ``sgroups``, the
    target groups ``tgroups``, the block ``x`` of ``x_shape`` and, on the
    card, the output ``y``.  A call copies into them only what is not already them,
    steps, and returns the static state groups, which the next step
    overwrites (the counterpart of JAX's donation; ``unpack_state`` hands
    out copies).  On the card the step is one CUDA graph, captured at the
    first step or by ``prepare``; on the CPU it runs ``fn`` eagerly.

    ``fn`` is the only reference the runner holds to its caller (a chain's
    bound ``process_block``): no closure of the runner refers to the
    runner, so it frees by refcounting alone once its owner drops it (the
    serving processes run with ``gc.disable()``)."""

    def __init__(self, fn, ex_state, ex_targets, x_shape, device=None,
                 packer=Packer, label="step"):
        self.state_packer = packer(ex_state)
        self.target_packer = Packer(ex_targets)
        leaves = flatten_like_jax(ex_state) + flatten_like_jax(ex_targets)
        self.device = torch.device(device if device is not None else
                                   (leaves[0].device if leaves else "cpu"))
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # The other cards whose static buffers the step reads (a mesh row's
        # model devices): their work joins the capture (``_with_sides``).
        self.sides = sorted({leaf.device for leaf in leaves if leaf.device.type == "cuda"}
                            - {self.device}, key=lambda d: d.index)
        self.fn = fn
        self.label = label
        self.sgroups = tuple(g.clone() for g in self.state_packer.pack(ex_state))
        self.tgroups = tuple(g.clone() for g in self.target_packer.pack(ex_targets))
        self.x = torch.zeros(x_shape, dtype=torch.float32, device=self.device)
        # On the card, once captured: (graph, static y, the kernel launches
        # one replay makes), set and dropped as one value so a step reads a
        # consistent triple (ops/kernels:credit).
        self.captured = None
        # The last capture's seconds (the tracer's chain.capture span,
        # warm-up aside).
        self.capture_s = None

    # -- JAX's methods ----------------------------------------------------
    def pack_state(self, state):
        return self.state_packer.pack(state)

    def unpack_state(self, sgroups=None):
        """The state tree of ``sgroups`` (default: the live static groups)
        as copies: the static buffers change at the next step."""
        groups = self.sgroups if sgroups is None else sgroups
        return tree_map(torch.clone, self.state_packer.unpack(groups))

    def pack_targets(self, targets):
        return self.target_packer.pack(targets)

    def __call__(self, sgroups, tgroups, x):
        self.write_state(sgroups)
        self.write_targets(tgroups)
        self.write_x(x)
        return self.run()

    # -- the static buffers -----------------------------------------------
    @staticmethod
    def _write(dst, src, what):
        if len(src) != len(dst):
            raise ValueError(f"{len(src)} {what} groups where the runner holds {len(dst)}")
        for d, s in zip(dst, src):
            if s is not d:
                d.copy_(s)

    def write_state(self, sgroups):
        """Copy packed state groups into the static ones (a group that is
        the static one itself is skipped)."""
        self._write(self.sgroups, sgroups, "state")

    def write_targets(self, tgroups):
        self._write(self.tgroups, tgroups, "target")

    def write_x(self, x):
        if x is not self.x:
            self.x.copy_(x)

    # -- the step ---------------------------------------------------------
    def _step(self):
        """unpack -> fn -> repack into the static state groups; returns y
        (a tensor, or a tuple of them).  Every new group is built (one
        ``torch.cat`` each, or a copy of a big leaf that aliases a static
        buffer) before any static group is written: a leaf ``fn`` returns
        may be a view of an input leaf."""
        state = self.state_packer.unpack(self.sgroups)
        targets = self.target_packer.unpack(self.tgroups)
        new_state, y = self.fn(state, targets, self.x)
        statics = {_storage(g) for g in self.sgroups + self.tgroups + (self.x,)}
        srcs = []
        for dst, src in zip(self.sgroups, self.state_packer.pack(new_state)):
            if src is dst:
                src = None  # a big leaf passed through unchanged
            elif _storage(src) in statics:
                src = src.clone()
            srcs.append(src)
        for dst, src in zip(self.sgroups, srcs):
            if src is not None:
                dst.copy_(src)
        # y must not be a view of a buffer the next step overwrites.
        return tree_map(lambda t: t.clone() if _storage(t) in statics else t, y)

    @property
    def graph(self):
        return None if self.captured is None else self.captured[0]

    def prepare(self):
        """On the card, warm up and capture the step: ``WARM_STEPS`` dummy
        steps on silence, then one capture.  The static buffers are restored after
        both, so the state is as it was.  Warm-up launches are set-up and
        not counted; the capture's launches are recorded and each replay
        counts them.  A step that also runs on side cards (``sides``) is
        captured as one graph across them (``_with_sides``).  Raises,
        naming ``label``, if either fails.  A no-op on the CPU and once
        captured."""
        if self.device.type != "cuda" or self.captured is not None:
            return
        from aefs_tpu_torch.ops import kernels

        with _capture_lock, torch.cuda.device(self.device):
            try:
                keep = [g.clone() for g in self.sgroups]
                x_keep = self.x.clone()
                self.x.zero_()
                stream = capture_stream(self.device)
                sides = [capture_stream(d) for d in self.sides]
                currents = [torch.cuda.current_stream(self.device)] + [
                    torch.cuda.current_stream(d) for d in self.sides]
                for s, cur in zip([stream] + sides, currents):
                    s.wait_stream(cur)
                with kernels.recording(), torch.cuda.stream(stream), \
                        _with_sides(self.device, stream, sides):
                    for _ in range(WARM_STEPS):
                        self._step()
                for s, cur in zip([stream] + sides, currents):
                    cur.wait_stream(s)
                graph = torch.cuda.CUDAGraph()
                graph.side_pools = [_side_pool(d) for d in self.sides]
                span = TRACER.timed("chain.capture", self.label)
                with kernels.recording() as record:
                    with torch.cuda.graph(graph, stream=stream,
                                          capture_error_mode="thread_local"), \
                            _with_sides(self.device, stream, sides, graph.side_pools):
                        y = self._step()
                span.close()
                self.capture_s = span.ns / 1e9
                TRACER.count("chain.captures")
                for g, k in zip(self.sgroups, keep):
                    g.copy_(k)
                self.x.copy_(x_keep)
            except Exception as e:
                raise RuntimeError(f"{self.label}: the step's warm-up or CUDA graph capture "
                                   f"failed: {e}") from e
        self.captured = (graph, y, record)

    def run(self):
        """One step on the static buffers -> (static state groups, y).  On
        the card: one replay of the captured graph (captured first if need
        be), on the current stream, ordered after and before the side
        cards' current streams; ``y`` is the static output."""
        if self.device.type != "cuda":
            return self.sgroups, self._step()
        if self.captured is None:
            self.prepare()
        graph, y, record = self.captured
        if self.sides:
            current = torch.cuda.current_stream(self.device)
            side_currents = [torch.cuda.current_stream(d) for d in self.sides]
            for s in side_currents:
                current.wait_stream(s)
            graph.replay()
            for s in side_currents:
                s.wait_stream(current)
        else:
            graph.replay()
        from aefs_tpu_torch.ops.kernels import credit

        credit(record)
        return self.sgroups, y

    def release(self):
        """Drop the graph and its output, and with them the graph's private
        memory pool; a later step captures again."""
        self.captured = None


class Staging:
    """A host array's way into a static device buffer: two pinned host
    buffers used in turn, each guarded by the event of its last copy, so
    the host never rewrites one a pending copy still reads, and the copy
    to the device is non-blocking (no wait on the stream).  On the CPU a
    plain copy into the (contiguous) destination."""

    def __init__(self, shape, device, dtype=torch.float32):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.bufs = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(2)]
            self.events = [None, None]
            self.next = 0

    def put(self, host, dst):
        """Copy the numpy array ``host`` (``dst``'s shape) into ``dst``."""
        if not self.cuda:  # straight into the host tensor's memory
            dst.numpy()[...] = host
            return
        k = self.next
        self.next ^= 1
        if self.events[k] is not None:
            self.events[k].synchronize()
        self.bufs[k].numpy()[...] = host
        dst.copy_(self.bufs[k], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dst.device))
        self.events[k] = ev
