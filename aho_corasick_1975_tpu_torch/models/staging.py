"""Host-to-device staging through a ring of pinned host slots and a copy
stream.

The JAX package has no module like this: its pipelined count
(``aho_corasick_1975_tpu/models/scanner.py:650-661``) dispatches each
chunk "without intermediate syncs, overlapping each chunk's host->device
transfer with the previous chunk's scan", because ``jnp.asarray`` of a
host buffer is an asynchronous ``device_put``. In PyTorch a copy from
pageable host memory is synchronous, so the port stages through memory it
pins itself, on a stream of its own.

A ``Stager`` belongs to one scanner and one device, and is used under the
scanner's dispatch lock. It holds ``depth`` slots in a ring, used in order
(slot i % depth). A slot is a pinned host buffer and, once a pipelined
scan uses it, a device buffer of the same bytes, with two events:

* ``copied``, recorded on the copy stream after the slot's copy (to the
  device, or from it for ``download``). The host waits on it before it
  refills the slot or copies it out, and the compute
  stream (the caller's current stream, where the kernels launch) waits on
  it before it launches on the device buffer;
* ``consumed``, recorded on the compute stream after the kernel that reads
  the device buffer (``release``). The copy stream waits on it before it
  overwrites the device buffer.

``stage`` puts one chunk of a pipelined scan in one slot and starts its
upload: its ``halo`` head ids (int32), then its ``ext`` in the raw dtype
(``halo`` OOV symbols, the chunk's symbols, the OOV pad). Only the head
ids and the symbols cross the link; ``ready`` zeroes the pad of the device
buffer on the compute stream, since a reused slot still holds the symbols
of the chunk before. A pipelined scan stages chunk i+1 (its fill, its copy
enqueued) before it launches chunk i (``ready``, the launch, ``release``):
chunk i+1's copy is in flight while the host enqueues chunk i's work, and
can run beside it on the card, and chunk i's kernel never waits on its
own copy. The host waits on no copy but that of the slot it refills.

``upload``/``upload_into`` copy any host array into a device tensor in
slot-sized pieces through the same ring, so pinned memory stays bounded by
the ring whatever the input's size: the host fills a piece while the piece
before it is copied. The copy stream first waits on the compute stream
(the tensor's memory may be the last kernel's), and the compute stream
waits on the copies before they return. A device buffer of the ring is
made on the compute stream and written on the copy stream, so it is marked
with ``record_stream`` for the copy stream: when the ring grows, its
memory is not handed out again before the copies into it are done. A
tensor filled by ``upload_into`` needs no such mark: the compute stream,
whose pool it returns to, waits on the copies before ``upload_into``
returns. ``download`` reads device tensors back the other way through the
ring, into host arrays of their own: the host copies a piece out of its
slot while the next piece is copied into the other slot.

The host's wait for a slot's last copy (``_take``) is the span
``ac.stage.wait``, and the host fill of a slot the span ``ac.stage.fill``
(utils/profiling.py).

On a CUDA device the slots are pinned and there is no fallback: if pinning
or the stream fails, the error is raised, and nothing is ever staged from
pageable memory. On the CPU (the tests) the slots and device buffers are
plain CPU tensors used in the same ring order, with no stream and no
events.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling

_ALIGN = 16   # bytes: where ``ext`` starts in a slot, after the head ids


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


class _ReadOnlyBytes:
    """The array interface of a read-only byte array (the bytes of a
    ``bytes``), marked writable: ``torch.from_numpy`` warns of any
    read-only array, and the fill only reads it."""

    def __init__(self, a: np.ndarray):
        self.base = a
        self.__array_interface__ = {"shape": (a.size,), "typestr": "|u1",
                                    "data": (a.ctypes.data, False),
                                    "version": 3}


def _fill(dst: torch.Tensor, src: np.ndarray) -> None:
    """The host fill of a slot: ``src``'s bytes into ``dst``, a byte view
    of the slot. Torch's copy runs on its intra-op threads, several times
    as fast as ``np.copyto`` into pinned memory on the card's host
    (PERF.md, the staging ring's findings)."""
    if not src.flags.writeable:
        src = np.asarray(_ReadOnlyBytes(src))
    dst.copy_(torch.from_numpy(src))


class _Slot:
    __slots__ = ("index", "host", "host_np", "dev", "copied", "consumed",
                 "chunk")

    def __init__(self, index: int, host: torch.Tensor, cuda: bool):
        self.index = index
        self.host = host
        self.host_np = host.numpy()
        self.dev = None
        self.chunk = None   # (halo, ext's first byte, bytes sent, end, dtype)
        self.copied = torch.cuda.Event() if cuda else None
        self.consumed = torch.cuda.Event() if cuda else None


class Stager:
    """A ring of ``depth`` host slots of at least ``slot_bytes`` each on
    ``device``, and its copy stream (module docstring). A chunk larger
    than a slot grows the ring, which then keeps that size. Counters:
    ``slots_used``, the slots taken so far (the next is ``slots_used %
    depth``), and ``pad_zeroed``, the bytes of pad zeroed in the device
    buffers."""

    def __init__(self, device, depth: int, slot_bytes: int):
        if depth < 2:
            raise ValueError(f"a staging ring needs 2 slots or more "
                             f"(got {depth})")
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if not self._cuda and self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.depth = depth
        self._copy = None
        if self._cuda:
            self._copy = torch.cuda.Stream(self.device)
            self.device = self._copy.device
        self.slots_used = 0
        self.pad_zeroed = 0
        self._slots: list = []
        self.slot_bytes = 0
        self._grow(slot_bytes)

    def _grow(self, nbytes: int) -> None:
        """A new ring of slots of ``nbytes`` bytes (rounded up to the
        alignment). The old slots' pinned memory stays held by the host
        allocator until the copies that read it are done."""
        nbytes = _aligned(max(nbytes, _ALIGN))
        self._slots = [
            _Slot(i, torch.empty(nbytes, dtype=torch.uint8,
                                 pin_memory=self._cuda), self._cuda)
            for i in range(self.depth)]
        self.slot_bytes = nbytes

    def _compute(self):
        return torch.cuda.current_stream(self.device)

    def _take(self) -> _Slot:
        """The next slot in ring order, once its last copy is done."""
        slot = self._slots[self.slots_used % self.depth]
        self.slots_used += 1
        with profiling.span("ac.stage.wait") as sp:
            sp.note("slot", slot.index)
            if self._cuda:
                slot.copied.synchronize()
        return slot

    def _device_buffer(self, slot: _Slot) -> torch.Tensor:
        if slot.dev is None:
            slot.dev = torch.empty(self.slot_bytes, dtype=torch.uint8,
                                   device=self.device)
            if self._cuda:
                slot.dev.record_stream(self._copy)
                # the memory may be a finished tensor of the compute
                # stream's whose last kernel is still in flight
                slot.consumed.record(self._compute())
        return slot.dev

    def _send(self, dst: torch.Tensor, slot: _Slot, n: int,
              after_consumed: bool) -> None:
        """Copy the slot's first ``n`` host bytes into ``dst`` on the copy
        stream (after the slot's ``consumed`` event with
        ``after_consumed``), then record its ``copied`` event."""
        if not self._cuda:
            dst.copy_(slot.host[:n])
            return
        with torch.cuda.stream(self._copy):
            if after_consumed:
                self._copy.wait_event(slot.consumed)
            dst.copy_(slot.host[:n], non_blocking=True)
            slot.copied.record(self._copy)

    # -- one chunk of a pipelined scan -----------------------------------

    def stage(self, head_ids: np.ndarray, body: np.ndarray,
              n_ext: int) -> _Slot:
        """Stage one chunk in the next slot and start its upload: ``ext``
        [n_ext] in ``body``'s dtype, ``halo = len(head_ids)`` OOV 0
        symbols, then ``body``, then OOV 0 up to n_ext; and ``head`` [halo]
        int32. ``ready(slot)`` gives them on the device, ``release(slot)``
        follows the launches that read them."""
        halo = len(head_ids)
        item = body.dtype.itemsize
        at = _aligned(4 * halo)
        end = at + n_ext * item
        if end > self.slot_bytes:
            self._grow(end)
        slot = self._take()
        used = at + (halo + len(body)) * item
        with profiling.span("ac.stage.fill") as sp:
            sp.note("bytes", used)
            slot.host_np[:4 * halo].view(np.int32)[:] = head_ids
            slot.host_np[at:at + halo * item] = 0
            _fill(slot.host[at + halo * item:used], body.view(np.uint8))
        self._send(self._device_buffer(slot)[:used], slot, used,
                   after_consumed=True)
        slot.chunk = (halo, at, used, end, body.dtype)
        return slot

    def ready(self, slot: _Slot):
        """(ext, head) of a staged chunk, views of the slot's device
        buffer, for launches on the compute stream: it waits on the
        slot's copy, and the pad past the chunk's symbols is zeroed on it
        (the buffer may hold the symbols of the chunk before)."""
        halo, at, used, end, dtype = slot.chunk
        if self._cuda:
            self._compute().wait_event(slot.copied)
        slot.dev[used:end].zero_()
        self.pad_zeroed += end - used
        return (slot.dev[at:end].view(_torch_dtype(dtype)),
                slot.dev[:4 * halo].view(torch.int32))

    def release(self, slot: _Slot) -> None:
        """The launches that read ``slot``'s device buffer are enqueued on
        the compute stream: the copy stream may overwrite it after them."""
        if self._cuda:
            slot.consumed.record(self._compute())

    # -- any host array --------------------------------------------------

    def upload(self, a: np.ndarray) -> torch.Tensor:
        """A device tensor of ``a``'s shape and dtype holding a copy of
        it, staged through the ring."""
        a = np.ascontiguousarray(a)
        out = torch.empty(a.shape, dtype=_torch_dtype(a.dtype),
                          device=self.device)
        self.upload_into(out, a)
        return out

    def padded(self, body: np.ndarray, halo: int, n: int,
               head_ids=None) -> torch.Tensor:
        """ext [halo + n] on the device in ``body``'s dtype: ``head_ids``
        (else OOV 0) over the halo, then ``body``, then OOV 0. Only the
        head and the body cross the link; the rest is zeroed on the
        compute stream."""
        T = len(body)
        ext = torch.empty(halo + n, dtype=_torch_dtype(body.dtype),
                          device=self.device)
        ext[halo + T:].zero_()
        if head_ids is None:
            ext[:halo].zero_()
        else:
            self.upload_into(ext[:halo], head_ids)
        self.upload_into(ext[halo:halo + T], body)
        return ext

    def upload_into(self, dst: torch.Tensor, a: np.ndarray) -> None:
        """Copy host array ``a`` into ``dst``, a contiguous tensor of as
        many bytes on the stager's device, in slot-sized pieces; ready on
        the compute stream when this returns."""
        src = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        if not dst.is_contiguous() or dst.device != self.device:
            raise ValueError("upload_into needs a contiguous tensor on "
                             f"{self.device}")
        out = dst.view(-1).view(torch.uint8)
        if out.numel() != src.size:
            raise ValueError(f"{src.size} bytes into a tensor of "
                             f"{out.numel()}")
        if not src.size:
            return
        if self._cuda:
            self._copy.wait_stream(self._compute())
        for a0 in range(0, src.size, self.slot_bytes):
            n = min(self.slot_bytes, src.size - a0)
            slot = self._take()
            with profiling.span("ac.stage.fill") as sp:
                sp.note("bytes", n)
                _fill(slot.host[:n], src[a0:a0 + n])
            self._send(out[a0:a0 + n], slot, n, after_consumed=False)
        if self._cuda:
            self._compute().wait_stream(self._copy)

    def download(self, *tensors: torch.Tensor) -> list:
        """Host copies of contiguous tensors on the stager's device, each
        a NumPy array that owns its memory, read back through the ring in
        slot-sized pieces: the copy stream (after the compute stream's
        work so far) copies a piece into a slot while the host copies the
        piece before it out of its slot."""
        outs, pieces = [], []
        for t in tensors:
            if not t.is_contiguous() or t.device != self.device:
                raise ValueError("download needs contiguous tensors on "
                                 f"{self.device}")
            out = np.empty(tuple(t.shape), _numpy_dtype(t.dtype))
            outs.append(out)
            src = t.view(-1).view(torch.uint8)
            dst = torch.from_numpy(out.reshape(-1).view(np.uint8))
            pieces += [(dst[a0:a0 + self.slot_bytes],
                        src[a0:a0 + self.slot_bytes])
                       for a0 in range(0, src.numel(), self.slot_bytes)]
        if self._cuda:
            self._copy.wait_stream(self._compute())
        pending = []
        for dst, src in pieces:
            slot = self._take()
            host = slot.host[:src.numel()]
            if self._cuda:
                with torch.cuda.stream(self._copy):
                    host.copy_(src, non_blocking=True)
                    slot.copied.record(self._copy)
            else:
                host.copy_(src)
            pending.append((dst, host, slot))
            if len(pending) > 1:
                self._copy_out(*pending.pop(0))
        for p in pending:
            self._copy_out(*p)
        return outs

    def _copy_out(self, dst: torch.Tensor, host: torch.Tensor,
                  slot: _Slot) -> None:
        if self._cuda:
            slot.copied.synchronize()
        dst.copy_(host)
