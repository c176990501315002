"""The work of each kernel launch on the H100, from its shapes: the bytes
it must move (each input read once, each output written once) and the
operations it must do, and the least time the card could take for them.

One copy of the formulas, read by ``chip_smoke.py``'s ``bound_ms`` columns
and by the kernel ledger (:mod:`fmda_tpu_torch.obs.device`), which sums
each launch's FLOPs and bytes for ``device_mfu`` and
``device_arithmetic_intensity``.  Each ``*_cost`` function returns a
:class:`Cost`; each ``*_bound`` function its :func:`roofline_ms`.  The
peaks are the H100 SXM's published dense rates (NVIDIA data sheet)."""

from __future__ import annotations

from typing import Dict, NamedTuple

#: HBM bandwidth (bytes/s)
PEAK_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores (FLOP/s)
PEAK_F32_FLOP_PER_S = 67e12
#: bf16 on the tensor cores, f32 accumulation (FLOP/s)
PEAK_BF16_TC_FLOP_PER_S = 989e12

#: the scans' gate blocks, carried states and element-wise operations per
#: (row, step, unit) of the forward and of the backward (a transcendental
#: counted as one).  LSTM: 4 gate adds, 4 nonlinearities, c' = f c + i g,
#: tanh(c'), o tanh(c'); each backward the recompute and cotangent algebra
SCAN_SHAPES = {
    "gru": dict(gates=3, states=1, fwd_ops=10, bwd_ops=30),
    "lstm": dict(gates=4, states=2, fwd_ops=14, bwd_ops=40),
}
#: operations per (row, unit) of the SSM tick, a transcendental counted as
#: one: 11 for a, s' and h, 4 for each EMA; the EMA rates' sigmoids once a
#: unit
SSM_OPS = 19
#: products per visible (query, key) pair, in units of D: the forward's
#: q.k and p.v; the dK/dV sweep's q.k, do.v, p^T do and ds^T q; the dQ
#: sweep's q.k, do.v and ds k; the fused backward's q.k, do.v, p^T do,
#: ds^T q and ds k
FLASH_FLOPS = {"flash_fwd": 4, "flash_dkv": 8, "flash_dq": 6, "flash_bwd": 10}
#: the backward kernels' outputs of (B*N, T, D)
FLASH_BWD_OUTPUTS = {"flash_dkv": 2, "flash_dq": 1, "flash_bwd": 3}


class Cost(NamedTuple):
    """One launch's work: bytes moved, product FLOPs (in the I/O dtype)
    and element-wise FLOPs (float32), and the I/O dtype's size."""

    bytes_moved: float
    product_flops: float
    elementwise_flops: float
    itemsize: int

    @property
    def flops(self) -> float:
        return self.product_flops + self.elementwise_flops


def roofline_ms(bytes_moved, product_flops, elementwise_flops, itemsize):
    """(bound_ms, bound_by): the larger of the bytes' time at the card's
    memory rate and the operations' time.  The products' operands are in
    the I/O dtype: float32 products run at the float32 rate beside the
    element-wise algebra; bf16 products (f32 accumulation) at the tensor
    cores' rate, alongside the element-wise algebra at the float32 rate."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_elem = elementwise_flops / PEAK_F32_FLOP_PER_S * 1e3
    if itemsize == 2:
        t_ops = max(product_flops / PEAK_BF16_TC_FLOP_PER_S * 1e3, t_elem)
    else:
        t_ops = product_flops / PEAK_F32_FLOP_PER_S * 1e3 + t_elem
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def scan_cost(batch, steps, hidden, itemsize, masked, *, gates=3,
              states=1, elementwise=10) -> Cost:
    """The forward scan: xp, the initial states and the weights in; the
    per-step hiddens, and cell states for the LSTM, and the final states
    out; 2*gH*H FLOPs per (row, step) for h . W_hh^T and ``elementwise``
    per (row, step, unit) for the gate algebra."""
    bytes_moved = itemsize * (
        batch * steps * gates * hidden          # xp in
        + states * batch * steps * hidden       # hs (and cs) out
        + 2 * states * batch * hidden           # initial in, final out
        + gates * hidden * hidden + gates * hidden)  # W_hh, b_hh in
    bytes_moved += batch * steps if masked else 0
    return Cost(bytes_moved, 2 * batch * steps * gates * hidden * hidden,
                elementwise * batch * steps * hidden, itemsize)


def scan_bound(batch, steps, hidden, itemsize, masked, *, gates=3,
               states=1, elementwise=10):
    """Least time for the forward scan on this card."""
    return roofline_ms(*scan_cost(batch, steps, hidden, itemsize, masked,
                                  gates=gates, states=states,
                                  elementwise=elementwise))


def scan_bwd_cost(batch, steps, hidden, itemsize, masked, *, gates=3,
                  states=1, elementwise=30) -> Cost:
    """The backward scan, its sweep and its weight gradient together: xp,
    hs (and cs), dhs, the initial states, W_hh, b_hh (I/O dtype), the final
    states' cotangents and the mask read once; dxp (I/O dtype), the initial
    states' gradients, dW_hh and db_hh (float32) written once; the gate
    recompute's, the dh chain's and the dW_hh products, 6·B·T·gH·H in all,
    and ``elementwise`` per (row, step, unit) of gate and cotangent
    algebra."""
    bt = batch * steps
    bytes_moved = itemsize * (
        bt * (gates * hidden + states * hidden + hidden + gates * hidden)
        + states * batch * hidden + gates * hidden * hidden + gates * hidden)
    bytes_moved += 4 * (2 * states * batch * hidden + gates * hidden * hidden
                        + gates * hidden)
    bytes_moved += bt if masked else 0
    return Cost(bytes_moved, 6 * gates * hidden * hidden * bt,
                elementwise * bt * hidden, itemsize)


def scan_bwd_bound(batch, steps, hidden, itemsize, masked, *, gates=3,
                   states=1, elementwise=30):
    """Least time for the backward scan on this card."""
    return roofline_ms(*scan_bwd_cost(batch, steps, hidden, itemsize, masked,
                                      gates=gates, states=states,
                                      elementwise=elementwise))


def ssm_cost(batch, hidden, itemsize) -> Cost:
    """One SSM step: xp (B, 3H), the three carries and the four (H,)
    vectors read once, four (B, H) outputs written once; the step's
    element-wise operations (no product)."""
    return Cost(itemsize * (10 * batch * hidden + 4 * hidden), 0,
                SSM_OPS * batch * hidden + 2 * hidden, itemsize)


def ssm_bound(batch, hidden, itemsize):
    """Least time for one SSM step on this card."""
    return roofline_ms(*ssm_cost(batch, hidden, itemsize))


def tick_cost(batch, n_layers, feats, hidden, classes, itemsize) -> Cost:
    """One fused serve tick: the rows, the slots, the lanes' norm rows,
    every layer's weights and the head read once, the lanes' state read
    and written once, pos read and written, the probabilities written; the
    projections' and the head's products and the step's and the norm's
    element-wise operations."""
    g = 3 * hidden
    weights = (g * (feats + hidden * (n_layers - 1)) + 7 * hidden * n_layers
               + classes * (g + 1))
    bytes_moved = (4 * batch * feats + 4 * batch + 2 * 4 * batch * feats
                   + itemsize * weights
                   + 2 * itemsize * 3 * n_layers * batch * hidden
                   + 2 * 8 * batch + 4 * batch * classes)
    products = 2 * batch * (g * (feats + hidden * (n_layers - 1))
                            + classes * g)
    elementwise = (batch * (SSM_OPS * hidden * n_layers + 2 * feats
                            + 2 * classes) + 2 * hidden * n_layers)
    return Cost(bytes_moved, products, elementwise, itemsize)


def tick_bound(batch, n_layers, feats, hidden, classes, itemsize):
    """Least time for one fused tick on this card."""
    return roofline_ms(*tick_cost(batch, n_layers, feats, hidden, classes,
                                  itemsize))


def flash_dense_pairs(batch, heads, seq, causal) -> int:
    """The (query, key) pairs the shapes allow with every key visible:
    T*T a head, T(T+1)/2 under the causal mask."""
    per_head = seq * (seq + 1) // 2 if causal else seq * seq
    return batch * heads * per_head


def flash_cost(kernel, c, itemsize, pairs, masked) -> Cost:
    """One flash kernel over the case ``c`` (``batch``, ``heads``, ``seq``,
    ``d``): its inputs read once (q, k, v; the backward also do, lse and
    delta; the key mask) and its outputs written once (o and lse; dk and
    dv; dq; dq, dk and dv); its products' FLOPs over ``pairs`` visible
    (query, key) pairs."""
    bntd = c["batch"] * c["heads"] * c["seq"] * c["d"]
    bnt = c["batch"] * c["heads"] * c["seq"]
    if kernel == "flash_fwd":
        bytes_moved = itemsize * 4 * bntd + 4 * bnt
    else:
        n_out = FLASH_BWD_OUTPUTS[kernel]
        bytes_moved = itemsize * (4 + n_out) * bntd + 2 * 4 * bnt
    bytes_moved += c["batch"] * c["seq"] if masked else 0
    return Cost(bytes_moved, FLASH_FLOPS[kernel] * c["d"] * pairs, 0,
                itemsize)


def flash_bound(kernel, c, itemsize, pairs, masked):
    """Least time for one flash kernel on this card."""
    return roofline_ms(*flash_cost(kernel, c, itemsize, pairs, masked))


def wide_gates_cost(cell, batch, hidden, itemsize, masked, backward=False,
                    prod=True, direct=True) -> Cost:
    """One step's fused gate kernel of the wide route
    (``csrc/scan_wide.cu``): element-wise, no product; the bytes its
    function needs, each read or written once.  Forward: xp_t and hh_t (gH
    each) read, h_t (and c_t) written; the GRU reads h_{t-1}, the LSTM
    c_{t-1}, and h_{t-1} only under a mask (a held row keeps it; a step
    that runs makes h from its gates and c alone).  Backward: xp_t, hh_t,
    the state(s) it reads (GRU h_{t-1}; LSTM c_{t-1} and c_t), dhs_t and
    the previous step's product (``prod``, absent at the first processed
    step) in the I/O dtype; dxp_t written, and for the GRU dhh_t too; the
    float32 direct part of dh read where ``direct`` is given (the GRU's
    always; the LSTM's at its first processed step and under a mask) and
    written by the GRU always, by the LSTM under a mask only (0 wherever a
    step ran); the LSTM's float32 dc read and written.  Operations: the
    cell's forward or backward count per (row, unit)."""
    s = SCAN_SHAPES[cell]
    gh, states = s["gates"] * hidden, s["states"]
    lstm = cell == "lstm"
    if backward:
        reads = 2 * gh + (states + 1 + (1 if prod else 0)) * hidden
        writes = gh * (1 if lstm else 2)
        f32_moves = ((1 if direct else 0)
                     + (1 if masked or not lstm else 0)
                     + (2 if lstm else 0))
        bytes_moved = batch * (itemsize * (reads + writes)
                               + 4 * f32_moves * hidden)
        ops = s["bwd_ops"]
    else:
        state_reads = states - (1 if lstm and not masked else 0)
        bytes_moved = itemsize * batch * (2 * gh + (state_reads + states)
                                          * hidden)
        ops = s["fwd_ops"]
    bytes_moved += batch if masked else 0
    return Cost(bytes_moved, 0, ops * batch * hidden, itemsize)


def wide_gates_bound(cell, batch, hidden, itemsize, masked, backward=False,
                     prod=True, direct=True):
    """Least time for one wide-route gate kernel on this card."""
    return roofline_ms(*wide_gates_cost(cell, batch, hidden, itemsize,
                                        masked, backward, prod, direct))


def gru_wide_step_cost(batch, hidden, itemsize, masked) -> Cost:
    """The fused GRU step (``csrc/gru_wide_step.cu``): W_hh (3H x H) and
    b_hh read once, xp_t (B x 3H) and h_{t-1} read, h_t written, the mask
    column; the product h_{t-1} W_hh^T, 2 B H 3H FLOPs in the I/O dtype,
    and the gate algebra, the GRU's forward count per (row, unit)."""
    gh = 3 * hidden
    bytes_moved = itemsize * (gh * hidden + gh + batch * (gh + 2 * hidden))
    bytes_moved += batch if masked else 0
    return Cost(bytes_moved, 2 * batch * hidden * gh,
                SCAN_SHAPES["gru"]["fwd_ops"] * batch * hidden, itemsize)


def gru_wide_step_bound(batch, hidden, itemsize, masked):
    """Least time for one fused GRU step on this card."""
    return roofline_ms(*gru_wide_step_cost(batch, hidden, itemsize, masked))


def gru_wide_bwd_step_cost(batch, hidden, itemsize, masked,
                           prod=True) -> Cost:
    """The fused GRU backward step (``csrc/gru_wide_bwd_step.cu``): W_hh
    (3H x H) and dhh_{t+1} (B x 3H) read once where the step has a product
    (``prod``; the first processed step has none), xp_t and hh_t (B x 3H),
    h_{t-1} and dhs_t read, the mask column, the float32 direct part of dh
    read and written; dxp_t (B x 3H) and dn r (B x H) written: dhh_t's r
    and z blocks are dxp_t's, stored once (the next step reads them from
    there).  The product dhh_{t+1} W_hh, 2 B 3H H FLOPs in the I/O dtype,
    and the cotangent algebra, the GRU's backward count per (row, unit)."""
    gh = 3 * hidden
    reads = batch * (2 * gh + 2 * hidden)
    if prod:
        reads += gh * hidden + batch * gh
    bytes_moved = itemsize * (reads + batch * (gh + hidden))
    bytes_moved += 4 * 2 * batch * hidden + (batch if masked else 0)
    return Cost(bytes_moved, 2 * batch * gh * hidden if prod else 0,
                SCAN_SHAPES["gru"]["bwd_ops"] * batch * hidden, itemsize)


def gru_wide_bwd_step_bound(batch, hidden, itemsize, masked, prod=True):
    """Least time for one fused GRU backward step on this card."""
    return roofline_ms(*gru_wide_bwd_step_cost(batch, hidden, itemsize,
                                               masked, prod))


def persist_sweep_cost(batch, steps, hidden, itemsize, masked) -> Cost:
    """The persistent LSTM backward sweep (``csrc/lstm_persist.cu``): xp,
    the recomputed hh, cs, dhs, c0 and W_hh read in the I/O dtype, dh_last
    and dc_last in float32, the mask; dxp written in the I/O dtype, dh0 and
    dc0 in float32; the dh chain's products, 2 B T 4H H FLOPs (T - 1 steps
    and dh0's), and the cotangent algebra, 40 per (row, step, unit).  The
    products over all B T rows around it (hh, dW_hh) are not its work."""
    bt, gh = batch * steps, 4 * hidden
    bytes_moved = itemsize * (bt * (2 * gh + 2 * hidden + gh) + batch * hidden
                              + gh * hidden)
    bytes_moved += 4 * 4 * batch * hidden + (bt if masked else 0)
    return Cost(bytes_moved, 2 * bt * gh * hidden,
                SCAN_SHAPES["lstm"]["bwd_ops"] * bt * hidden, itemsize)


def persist_sweep_bound(batch, steps, hidden, itemsize, masked):
    """Least time for the persistent LSTM backward sweep on this card."""
    return roofline_ms(*persist_sweep_cost(batch, steps, hidden, itemsize,
                                           masked))


def persist_l2_bytes(plan, batch, hidden, itemsize, backward) -> int:
    """The L2 bytes a step of a persistent LSTM scan reads for its staged
    operand (h_{t-1} forward, H wide; the gate gradients backward, 4 H):
    each cluster of the plan reads its batch tile's rows once and
    multicasts them, so Q / C reads of every row."""
    width = (4 if backward else 1) * hidden
    return plan["slices"] // plan["cluster"] * batch * width * itemsize


def _scan_fwd(cell):
    s = SCAN_SHAPES[cell]
    return lambda sig: scan_cost(*sig, gates=s["gates"], states=s["states"],
                                 elementwise=s["fwd_ops"])


def _scan_bwd(cell):
    s = SCAN_SHAPES[cell]
    return lambda sig: scan_bwd_cost(*sig, gates=s["gates"],
                                     states=s["states"],
                                     elementwise=s["bwd_ops"])


def _flash(kernel):
    def cost(sig):
        batch, heads, seq, d, itemsize, causal, masked = sig
        return flash_cost(kernel, dict(batch=batch, heads=heads, seq=seq,
                                       d=d), itemsize,
                          flash_dense_pairs(batch, heads, seq, causal),
                          masked)
    return cost


#: kernel name -> cost of one launch from the signature its wrapper books
#: (:func:`fmda_tpu_torch.ops.book_launch`):
#:
#: - the scans: ``(batch, steps, hidden, itemsize, masked)``; a backward
#:   scan's cost covers its weight-gradient kernel too, so ``scan_dw``'s
#:   own launches book no work;
#: - ``ssm_step``: ``(batch, hidden, itemsize)``;
#: - ``ssm_tick``: ``(batch, n_layers, feats, hidden, classes, itemsize)``;
#: - the flash kernels: ``(batch, heads, seq, d, itemsize, causal,
#:   masked)``, over every pair the shapes allow (what a key mask hides
#:   is data, read only on the card);
#: - the wide route's gate kernels, one launch a step: ``(batch, hidden,
#:   itemsize, masked)`` forward, ``(batch, hidden, itemsize, masked,
#:   prod, direct)`` backward, their element-wise work alone: where a gate
#:   kernel runs, the step's product is a cuBLAS ``addmm``, no kernel of
#:   the port's, and books nothing;
#: - the fused GRU step, one launch a step: ``(batch, hidden, itemsize,
#:   masked)``, the step's product and gate algebra together; its backward
#:   ``(batch, hidden, itemsize, masked, prod)``, the product (none at a
#:   direction's first processed step) and the gate gradients;
#: - the persistent LSTM scans, one launch a direction: ``(batch, steps,
#:   hidden, itemsize, masked)``, the forward a scan's work, the backward
#:   its sweep's.
LAUNCH_COSTS: Dict[str, object] = {
    "gru_scan_fwd": _scan_fwd("gru"),
    "gru_scan_bwd": _scan_bwd("gru"),
    "lstm_scan_fwd": _scan_fwd("lstm"),
    "lstm_scan_bwd": _scan_bwd("lstm"),
    "scan_dw": lambda sig: Cost(0, 0, 0, 4),
    "ssm_step": lambda sig: ssm_cost(*sig),
    "ssm_tick": lambda sig: tick_cost(*sig),
    **{k: _flash(k) for k in FLASH_FLOPS},
    **{f"{cell}_wide_fwd": (lambda sig, cell=cell: wide_gates_cost(
        cell, *sig)) for cell in SCAN_SHAPES},
    **{f"{cell}_wide_bwd": (lambda sig, cell=cell: wide_gates_cost(
        cell, *sig[:4], backward=True, prod=sig[4], direct=sig[5]))
        for cell in SCAN_SHAPES},
    "lstm_persist_fwd": _scan_fwd("lstm"),
    "lstm_persist_bwd": lambda sig: persist_sweep_cost(*sig),
    "gru_wide_step_fwd": lambda sig: gru_wide_step_cost(*sig),
    "gru_wide_bwd_step": lambda sig: gru_wide_bwd_step_cost(*sig),
}
