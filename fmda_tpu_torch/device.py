"""Device selection for the port's entry points, and the runtime's
copies between the host and the card.

The card is the default: ``device=None`` means ``cuda``.  Without a card
the entry points raise instead of carrying on on the CPU unasked; the
caller passes ``device="cpu"`` to run the plain PyTorch versions there.
"""

from __future__ import annotations

from typing import Dict, Hashable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; any CUDA device needs a visible card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fmda_tpu_torch runs on a CUDA card by default and none is "
            "visible; pass device='cpu' to run the plain PyTorch path on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


class PinnedStaging:
    """Copies between the host and a card through pinned buffers, each
    copy non-blocking with an event recorded right behind it, so that a
    caller waits on that copy alone and never on the whole stream (a flush
    dispatched later keeps running).  Buffers are made once per key and
    layout and reused.  On the CPU nothing is copied.

    - :meth:`to_device` packs arrays into one pinned buffer, sends it in
      one copy to a device buffer of the same key, and returns views of
      that device buffer.  It rewrites the pinned buffer only once the
      last copy out of it has run, so the caller may reuse its arrays as
      soon as it returns.  The next call with the same key rewrites the
      device buffer in stream order: work queued on the views before that
      call reads these values, and a caller that keeps the views longer
      gives them a key of their own.
    - :meth:`to_host` copies a tensor into the pinned buffer of ``key``;
      :meth:`wait` blocks on that copy's event.  A key is used again only
      after :meth:`wait` has taken its last copy: the caller keeps that
      rule (the gateways alternate two parities a bucket)."""

    #: every array packed by :meth:`to_device` starts at a multiple of this
    ALIGN = 8

    def __init__(self) -> None:
        self._uploads: Dict[Hashable, tuple] = {}
        self._downloads: Dict[Hashable, tuple] = {}

    def to_device(self, key: Hashable, arrays: Sequence[np.ndarray],
                  device: torch.device) -> Tuple[torch.Tensor, ...]:
        """``arrays`` on ``device`` by one non-blocking copy (on the CPU,
        the arrays themselves as tensors)."""
        if device.type != "cuda":
            return tuple(torch.from_numpy(np.ascontiguousarray(a))
                         for a in arrays)
        layout = (key, tuple((a.dtype.str, a.shape) for a in arrays))
        entry = self._uploads.get(layout)
        if entry is None:
            # plain tensors, so that a copy may land in them in and out
            # of inference mode alike
            with torch.inference_mode(False):
                entry = self._uploads[layout] = self._upload(arrays, device)
        host, host_views, copied, dev, dev_views = entry
        copied.synchronize()
        for view, a in zip(host_views, arrays):
            view[...] = a
        dev.copy_(host, non_blocking=True)
        copied.record()
        return dev_views

    def _upload(self, arrays, device):
        """The buffers of one :meth:`to_device` layout: pinned and device
        bytes, each array's view of both, and the copy's event."""
        spans, nbytes = [], 0
        for a in arrays:
            spans.append((nbytes, a.nbytes, a.dtype, a.shape))
            nbytes += -(-a.nbytes // self.ALIGN) * self.ALIGN
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
        buf = host.numpy()
        host_views = tuple(buf[at:at + n].view(dtype).reshape(shape)
                           for at, n, dtype, shape in spans)
        dev_views = tuple(
            dev[at:at + n].view(torch.from_numpy(np.empty(0, dtype)).dtype)
            .view(shape) for at, n, dtype, shape in spans)
        return host, host_views, torch.cuda.Event(), dev, dev_views

    def to_host(self, tensor: torch.Tensor, key: Hashable):
        """Begin the copy of ``tensor`` home; returns the handle
        :meth:`wait` takes."""
        if tensor.device.type != "cuda":
            return tensor, None
        layout = (key, tuple(tensor.shape), tensor.dtype)
        entry = self._downloads.get(layout)
        if entry is None:
            with torch.inference_mode(False):
                entry = self._downloads[layout] = (
                    torch.empty(tuple(tensor.shape), dtype=tensor.dtype,
                                pin_memory=True), torch.cuda.Event())
        host, copied = entry
        host.copy_(tensor, non_blocking=True)
        copied.record()
        return host, copied

    @staticmethod
    def wait(handle) -> np.ndarray:
        """The tensor of a :meth:`to_host` handle as a host array of its
        own (the pinned buffer serves a later copy)."""
        tensor, copied = handle
        if copied is None:
            return tensor.numpy()
        copied.synchronize()
        return tensor.numpy().copy()
