"""The recurrent weight gradient of the GRU and LSTM backward scans, as a
hand-written CUDA kernel, with its plain version.

- :func:`scan_dw` computes ``dW_hh = sum_{b,t} dg[b,t]^T h_prev[b,t]`` and
  ``db_hh = sum_{b,t} dg[b,t]`` in float32 from a backward sweep's gate
  gradient ``dg`` (B, T, gH), where ``h_prev`` is the hidden state entering
  each step: ``hs`` one step earlier in processing order, ``h0`` at the
  first processed step.  It is the port of the weight-gradient sums inside
  ``fmda_tpu/ops/pallas_gru.py``'s ``_gru_bwd_kernel`` and
  ``pallas_lstm.py``'s ``_lstm_bwd_kernel``, moved out of the serial time
  loop: nothing in the recurrence needs them.
- :func:`scan_dw_reference` is its plain version.

``tail`` (B, T, Ht), when given, replaces dg's last Ht columns: the GRU's
hidden projection sees ``dn_pre`` through the reset gate, so its n slice is
the sweep's ``round(dn_pre * r)``, not dxp's ``round(dn_pre)``.

On CUDA tensors :func:`scan_dw` launches the kernel (from
``csrc/scan_dw.cu``, in the library :mod:`fmda_tpu_torch.ops._cuda_lib`
builds at first use) or raises; on CPU tensors it runs the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fmda_tpu_torch.ops import _cuda_lib, call_booked, count_launch

# the wrapper's device test, a module global so a rehearsal can stub it
_on_cpu = _cuda_lib.on_cpu

#: Kernel launches made by :func:`scan_dw` and the backward scans (CPU
#: calls do not count).
launches = 0

Tensor = torch.Tensor


def h_prev_of(h0: Tensor, hs: Tensor, *, reverse: bool = False) -> Tensor:
    """(B, T, H): the hidden state entering each step, in time order."""
    if reverse:
        shifted = torch.cat([hs[:, 1:], h0[:, None]], dim=1)
    else:
        shifted = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    return shifted[:, :hs.shape[1]]


def scan_dw_reference(
    dg: Tensor,
    h0: Tensor,
    hs: Tensor,
    *,
    reverse: bool = False,
    tail: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The plain version of :func:`scan_dw`: (dw_hh (gH, H), db_hh (gH,)),
    float32 sums of the rounded gate gradients' products."""
    f32 = torch.float32
    gh, hidden = dg.shape[-1], h0.shape[-1]
    if tail is not None:
        dg = torch.cat([dg[..., :gh - tail.shape[-1]], tail], dim=-1)
    rows = dg.reshape(-1, gh).to(f32)
    h_prev = h_prev_of(h0.to(hs.dtype), hs, reverse=reverse)
    return (torch.matmul(rows.t(), h_prev.reshape(-1, hidden).to(f32)),
            rows.sum(dim=0))


def scan_dw(
    dg: Tensor,
    h0: Tensor,
    hs: Tensor,
    *,
    reverse: bool = False,
    tail: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """dW_hh and db_hh of a backward scan: the signature of
    :func:`scan_dw_reference`.  CUDA tensors launch the kernel (counted in
    :data:`launches`) or raise; CPU tensors run the plain version."""
    tensors = [dg, h0, hs] + ([tail] if tail is not None else [])
    if _on_cpu("scan_dw", tensors):
        return scan_dw_reference(dg, h0, hs, reverse=reverse, tail=tail)
    return _launch(dg, h0, hs, reverse=reverse, tail=tail)


def _launch(dg, h0, hs, *, reverse, tail):
    global launches
    if dg.dtype not in _cuda_lib.SUPPORTED:
        raise TypeError(
            f"scan_dw kernel takes float32 or bfloat16, got {dg.dtype}")
    batch, n_steps, gh = dg.shape
    hidden = h0.shape[-1]
    tail_from = gh - (0 if tail is None else tail.shape[-1])
    expect = {"h0": (batch, hidden), "hs": (batch, n_steps, hidden)}
    given = {"h0": h0, "hs": hs}
    if tail is not None:
        expect["tail"] = (batch, n_steps, gh - tail_from)
        given["tail"] = tail
    _cuda_lib.check_shapes(expect, given)
    dg = dg.contiguous()
    h0, hs = (t.to(dg.dtype).contiguous() for t in (h0, hs))
    tail = None if tail is None else tail.to(dg.dtype).contiguous()
    lib = _cuda_lib.load()
    device = _cuda_lib.device_index(dg)
    n_acc = gh * hidden + gh
    f32 = dict(dtype=torch.float32, device=dg.device)
    splits = lib.fmda_scan_dw_splits(batch, n_steps, hidden, gh, device)
    partials = torch.empty((splits, n_acc), **f32)
    dw_db = torch.empty((n_acc,), **f32)
    fn = getattr(lib, f"fmda_scan_dw_{_cuda_lib.SUPPORTED[dg.dtype]}")
    err = call_booked(
        "scan_dw", (batch, n_steps, hidden), fn,
        (dg.data_ptr(), gh, None if tail is None else tail.data_ptr(),
         tail_from, hs.data_ptr(), h0.data_ptr(), batch, n_steps, hidden,
         gh, int(bool(reverse)), partials.data_ptr(), dw_db.data_ptr(),
         device, _cuda_lib.stream_of(dg)))
    _cuda_lib.raise_on(lib, err, "scan_dw")
    launches += 1
    count_launch()
    return dw_db[:gh * hidden].view(gh, hidden), dw_db[gh * hidden:]
