"""Roofline analysis of a traced step (``repro/launch/roofline.py``), with
NVIDIA H100 figures.

Three terms per (arch, shape) on a mesh, per rank:

    compute    = FLOPs_per_rank / peak FLOP/s of the compute dtype
    memory     = bytes_per_rank / HBM bandwidth
    collective = sum over collectives of ring_bytes / its group's link rate

Figures (NVIDIA H100 SXM5 80 GB data sheet, 700 W, dense, no sparsity):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them,
3.35 TB/s of HBM, 80 GB of it. Links: NVLink 4 gives 450 GB/s a direction
between cards of one 8-card node; across nodes each card has one 400 Gb/s
NDR InfiniBand port, 50 GB/s. A collective's group lies within one node
when all its ranks share ``rank // 8``.

The counts come from running the step eagerly on fake tensors
(:mod:`repro_torch.launch.dryrun`) under :class:`StepCounter`, which sees
every op a rank runs on its local tensors (it lets DTensor desugar first):

* FLOPs: ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` totals: matrix products, convolutions, attention),
  per op on the local shapes;
* bytes: the sum of each op's input and output bytes. Every op is counted
  as a kernel that reads its inputs and writes its outputs once, so this is
  an unfused upper bound, unlike XLA's count after fusion;
* collectives (:func:`collectives_from_trace`): each ``_c10d_functional``
  op's kind, operand and output bytes and group ranks, under the
  reference's ring model over the group size g: all-reduce 2*S*(g-1)/g,
  all-gather, reduce-scatter and all-to-all S*(g-1)/g, permute S.

Eager PyTorch runs every layer, so the counts need none of the reference's
calibration for XLA's scan bodies; :func:`correct_with_calibration` stays
for an L-sweep check.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM5 80 GB, 700 W (data sheet; dense rates)
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
NVLINK_BW = 450e9          # NVLink 4, per direction, within one 8-card node
NET_BW = 50e9              # 400 Gb/s NDR InfiniBand per card, across nodes
NODE_CARDS = 8

# torch's functional collectives under the reference's (HLO) names
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def link_bw(ranks) -> float:
    """The link rate of a collective group: NVLink within one node, the
    network across nodes."""
    return NVLINK_BW if len({r // NODE_CARDS for r in ranks}) <= 1 else NET_BW


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS_BF16 if dtype in ("bfloat16", "float16") else PEAK_FLOPS_F32


def collectives_from_trace(records) -> dict:
    """Returns {kind: {count, ring_bytes, raw_bytes, link_s}} per rank.

    ``records``: one dict per collective, ``{"kind": <HLO name>,
    "in_bytes": operand bytes, "out_bytes": output bytes, "ranks": group
    ranks}``. ``link_s`` is the ring bytes over the group's link rate."""
    out: dict[str, dict] = {}
    for rec in records:
        base = rec["kind"]
        g = max(len(rec["ranks"]), 2)
        s_out = float(rec["out_bytes"])
        raw = float(rec["in_bytes"] or s_out)
        if base == "all-reduce":
            ring = 2 * s_out * (g - 1) / g
        elif base == "all-gather":
            ring = s_out * (g - 1) / g
        elif base == "reduce-scatter":
            ring = raw * (g - 1) / g
        elif base == "all-to-all":
            ring = max(raw, s_out) * (g - 1) / g
        else:  # collective-permute
            ring = s_out
        agg = out.setdefault(base, {"count": 0, "ring_bytes": 0.0, "raw_bytes": 0.0,
                                    "link_s": 0.0})
        agg["count"] += 1
        agg["ring_bytes"] += ring
        agg["raw_bytes"] += raw
        agg["link_s"] += ring / link_bw(rec["ranks"])
    return out


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


_NO_BYTES = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
             torch.ops.aten.detach}


class StepCounter(TorchDispatchMode):
    """Counts what each op of a rank does on its local tensors: FLOPs,
    bytes moved, and the collectives with their groups (see the module
    docstring). Use as a context manager; read ``flops``, ``bytes`` and
    ``collectives`` after. ``fake_mode``: the ``FakeTensorMode`` whose
    tensors the traced step runs on; ops on meta tensors and on another
    mode's fakes (DTensor infers output shapes that way) are not counted."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode     # the run's own FakeTensorMode, if it runs on fakes
        self.flops = 0
        self.bytes = 0
        self.collectives: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor desugar into local ops first
        packet = func._overloadpacket
        if packet not in flop_registry and func.namespace == "aten":
            with self:                 # count what a composite op decomposes into
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if any(t.is_meta or (isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode)
               for t in _tensors((args, kwargs))):
            return out                 # DTensor's shape propagation at global shapes, not work
        if func.namespace == "_c10d_functional":
            if packet.__name__ in _KINDS:
                self.collectives.append(_collective(packet.__name__, args, out))
            return out
        if func.namespace != "aten":
            return out
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and packet not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


def _collective(name, args, out) -> dict:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = [a for a in args if isinstance(a, str)][-1]    # the group name comes last
    return {"kind": _KINDS[name], "op": name,
            "in_bytes": sum(_nbytes(t) for t in _tensors(args)),
            "out_bytes": sum(_nbytes(t) for t in _tensors(out)),
            "ranks": list(dist.get_process_group_ranks(_resolve_process_group(group)))}


def cost_metrics(counter) -> dict:
    """The counter's per-rank totals, under the reference's keys. Bytes are
    the unfused upper bound; transcendentals are not counted."""
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "transcendentals": None}


def memory_metrics(peak_bytes: int) -> dict:
    """A rank's peak (``MemTracker``'s) against the card's 80 GB."""
    return {"peak_hbm_bytes": int(peak_bytes), "hbm_bytes": int(HBM_BYTES),
            "fits": bool(peak_bytes <= HBM_BYTES)}


@dataclass
class Corrected:
    flops: float
    bytes: float
    coll_ring: float
    coll_raw: float


def correct_with_calibration(period_metrics: dict, layer_metrics: dict | None,
                             outside_base: dict, n_layers: int, period: int) -> Corrected:
    """total = outside + (L // p) * group + (L % p) * layer."""
    reps, rem = divmod(n_layers, period)

    def total(key):
        g = period_metrics[key]
        m = layer_metrics[key] if layer_metrics else 0.0
        o = outside_base[key]
        return o + reps * g + rem * m

    return Corrected(
        flops=total("flops"), bytes=total("bytes"),
        coll_ring=total("coll_ring"), coll_raw=total("coll_raw"),
    )


def roofline_terms(flops: float, bytes_: float, coll_ring: float, *,
                   collective_s: float | None = None,
                   flops_peak: float = PEAK_FLOPS_BF16) -> dict:
    """The three terms in seconds. ``collective_s`` is the per-group link
    time (:func:`collectives_from_trace`'s ``link_s`` summed); without it
    the ring bytes go over NVLink."""
    t_c = flops / flops_peak
    t_m = bytes_ / HBM_BW
    t_x = coll_ring / NVLINK_BW if collective_s is None else collective_s
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    bound = max(t_c, t_m, t_x)
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "dominant": dom,
        "bound_s": bound,
        "roofline_fraction": (t_c / bound) if bound > 0 else 0.0,
    }


# --------------------------------------------------------- analytic FLOPs
def count_params(cfg, active_only: bool = False) -> float:
    """Parameter count (non-embedding by convention for 6ND).

    ``active_only`` gives the *execution-weighted* count used for
    MODEL_FLOPS: MoE experts at top_k of n_experts; the zamba2 shared block
    at n_sites executions (stored once, run L/p times)."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd = cfg.resolved_head_dim
    per_layer = 0.0
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        din = s.expand * d
        h = din // s.headdim
        per_layer = d * din * 2 + d * s.d_state * 2 + d * h + din * d
        total = per_layer * L
        if cfg.family == "hybrid":
            n_sites = L // cfg.hybrid_attn_every
            attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2 + 3 * d * ff
            total += attn * (n_sites if active_only else 1)
        return float(total)
    elif cfg.mla is not None:
        m = cfg.mla
        qk = m.nope_head_dim + m.rope_head_dim
        per_layer = (
            d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
            + d * (m.kv_lora_rank + m.rope_head_dim)
            + m.kv_lora_rank * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
            + cfg.n_heads * m.v_head_dim * d + 3 * d * ff
        )
    elif cfg.family == "moe":
        moe = cfg.moe
        attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
        e_used = moe.top_k if active_only else moe.n_experts
        experts = e_used * 3 * d * moe.d_expert
        shared = moe.n_shared * 3 * d * moe.d_expert
        dense = 3 * d * moe.dense_ff_parallel
        router = d * moe.n_experts
        per_layer = attn + experts + shared + dense + router
    else:
        attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
        per_layer = attn + 3 * d * ff
    total = per_layer * L
    if cfg.family == "encdec":
        enc_layer = d * cfg.n_heads * hd * 4 + 3 * d * ff
        cross = d * cfg.n_heads * hd * 4
        total += enc_layer * cfg.n_encoder_layers + cross * cfg.n_layers
    return float(total)


def model_flops(cfg, shape) -> float:
    """Global MODEL_FLOPS for the cell: 6*N_active*D train, 2*N_active*D
    prefill, 2*N_active*B decode-step."""
    n_act = count_params(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch  # one decode token per sequence


def step_share(measured_s: float, flops: float, bytes_: float, dtype: str) -> dict:
    """A measured step against its bound on one card: the bound's terms at
    the compute dtype's peak and HBM rate, and the share ``bound / measured``."""
    terms = roofline_terms(flops, bytes_, 0.0, flops_peak=peak_flops(dtype))
    return {**terms, "measured_s": measured_s, "share": terms["bound_s"] / measured_s}
