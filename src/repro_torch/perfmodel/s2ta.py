"""S2TA analytical PPA model (the port's own copy of
``repro.perfmodel.s2ta``: plain Python, no torch, the same names and
results) — reproduces the paper's evaluation
(Figs. 1/3/9/10/11/12, Tables 1/2/4) from a component power/cycle model.

Methodology: the paper's absolute anchors calibrate a small set of
constants; everything else follows from explicit activity-scaling rules.
Anchors (16nm, 1 GHz, 2048 INT8 MACs, 4 TOPS dense peak):

  * dense-SA component split (Fig. 1): MAC 20%, operand buffers 34%,
    accumulators 21%, SRAM 20%, MCU 5% — "the INT8 MAC datapath is
    compact; buffers dominate".
  * SA-ZVCG = 381 mW  (Table 4: 10.5 TOPS/W at 4 TOPS, 50/50 sparsity)
    -> calibrates the clock-gating residual r (gated register still burns
    r of its power: clock tree, leakage).
  * dense SA = 508 mW  (SA-ZVCG is 25% lower energy than SA, §8.4).
  * SA-SMT  = 799 mW  (8.01 TOPS/W at 1.6x speedup = 6.4 TOPS effective)
    -> calibrates the staging-FIFO factor F_smt (the paper's Overhead 1).
  * S2TA-W  = 645 mW  (12.4 TOPS/W at 8 TOPS) -> TPE buffer factor F_w.
  * S2TA-AW = 559 mW  (14.3 TOPS/W at 8 TOPS eff.; Table 2 measures
    541 mW at the design point) -> TPE+time-unrolled factor F_aw.

Speedup rules (cycle model):
  * SA / SA-ZVCG: 1x (ZVCG saves power, never time — §2.1).
  * SA-SMT(T, Q): eta(Q) * min(T, 1/(d_w d_a)), eta(2)=0.8, eta(4)=0.9
    (Fig. 3: 1.6x / 1.8x at 50/50).
  * S2TA-W: 2x when the layer's weights meet 4/8 DBB, else dense 1x.
  * S2TA-AW (time-unrolled): BZ/NNZ_a with NNZ_a in {1..5, 8(dense)} —
    per-layer variable activation density, cap 8x (paper §5.2, Fig. 9d;
    Table 4: 8 TOPS at 4/8 activations, 16 TOPS at 2/8).

DBB compression: a compressed stream moves (NNZ+1)/BZ of the dense bytes
(INT8 values + 1B bitmask per 8-block, Fig. 5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List

from repro_torch.perfmodel.workloads import ConvLayer

F_CLK = 1.0e9  # Hz, 16nm
N_MACS = 2048
DENSE_TOPS = 4.0  # 2 ops/MAC

# Fig. 1 component split of the dense SA, absolute scale from the anchors.
P_DENSE_SA = 508.0  # mW
P_MAC = 0.20 * P_DENSE_SA
P_OPBUF = 0.34 * P_DENSE_SA
P_ACCBUF = 0.21 * P_DENSE_SA
P_SRAM = 0.20 * P_DENSE_SA  # split W:A by access ratio ~ 0.35 : 0.65
P_SRAM_W = 0.35 * P_SRAM
P_SRAM_A = 0.65 * P_SRAM
P_MCU = 0.05 * P_DENSE_SA

P_ZVCG_ANCHOR = 4.0 / 10.5 * 1e3  # 381.0 mW
P_SMT_ANCHOR = 6.4 / 8.01 * 1e3  # 799.0 mW
P_W_ANCHOR = 8.0 / 12.4 * 1e3  # 645.2 mW
P_AW_ANCHOR = 8.0 / 14.3 * 1e3  # 559.4 mW
P_DAP = 10.4  # mW, Table 2
P_MCU_TPE = 50.4  # mW, Table 2 (4x Cortex-M33 cluster)


def _gate(r: float, activity: float) -> float:
    """Clock-gated component: residual r + active fraction."""
    return r + (1.0 - r) * activity


def _calibrate_r() -> float:
    """Solve P_zvcg(0.5, 0.5) == anchor for the gating residual."""
    # P = P_MAC*g(daw) + P_OPBUF*g(op) + P_ACCBUF*g(daw) + P_SRAM + P_MCU
    # with daw = 0.25, op = 0.5 at the anchor point.
    fixed = P_SRAM + P_MCU
    # g(a) = r + (1-r)a -> linear in r
    # coeff: P_MAC*(0.25 + 0.75 r) + P_OPBUF*(0.5+0.5 r) + P_ACC*(0.25+0.75 r)
    c0 = (P_MAC + P_ACCBUF) * 0.25 + P_OPBUF * 0.5 + fixed
    c1 = (P_MAC + P_ACCBUF) * 0.75 + P_OPBUF * 0.5
    return (P_ZVCG_ANCHOR - c0) / c1


R_GATE = _calibrate_r()


def dbb_stream_ratio(nnz: int, bz: int = 8) -> float:
    """Compressed bytes / dense bytes for INT8 + 1B bitmask per block."""
    if nnz >= bz:
        return 1.0
    return (nnz + 1) / bz


def nnz_a_of(d_a: float, bz: int = 8, cap: int = 5) -> int:
    """DAP per-layer NNZ: 1..cap maxpool stages, else dense bypass (§6.2)."""
    n = max(1, math.ceil(d_a * bz - 1e-9))
    return n if n <= cap else bz


def nnz_w_of(d_w: float, bz: int = 8) -> int:
    n = max(1, math.ceil(d_w * bz - 1e-9))
    return n if n <= bz // 2 else bz  # 4/8 provisioned; denser -> fallback


# ---------------------------------------------------------------- designs


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    name: str
    speedup: float  # vs dense SA cycles
    power_mw: float

    @property
    def tops(self) -> float:
        return DENSE_TOPS * self.speedup

    @property
    def tops_per_w(self) -> float:
        return self.tops / (self.power_mw / 1e3)


def sa(d_w: float, d_a: float) -> DesignPoint:
    return DesignPoint("SA", 1.0, P_DENSE_SA)


def sa_zvcg(d_w: float, d_a: float) -> DesignPoint:
    daw = d_w * d_a
    p = (
        P_MAC * _gate(R_GATE, daw)
        + P_OPBUF * _gate(R_GATE, (d_w + d_a) / 2)
        + P_ACCBUF * _gate(R_GATE, daw)
        + P_SRAM
        + P_MCU
    )
    return DesignPoint("SA-ZVCG", 1.0, p)


def _f_smt() -> float:
    """FIFO factor from the 50/50 anchor.  The staging FIFOs shuffle data
    EVERY cycle (that is the paper's Overhead 1 — they never idle), while
    MAC/accumulator activity is the fraction of dense-equivalent work
    retired per cycle: speedup x d_w d_a."""
    util = 1.6 * 0.25
    fixed = P_MAC * util + P_ACCBUF * util + P_SRAM * 1.125 + P_MCU
    return (P_SMT_ANCHOR - fixed) / P_OPBUF


F_SMT = _f_smt()


def sa_smt(d_w: float, d_a: float, t: int = 2, q: int = 2) -> DesignPoint:
    eta = {2: 0.8, 4: 0.9}[q]
    daw = max(d_w * d_a, 1e-3)
    speed = max(1.0, eta * min(float(t), 1.0 / daw))
    util = min(1.0, speed * daw)  # MACs retiring useful products
    p = (
        P_MAC * util
        + P_OPBUF * F_SMT * (1.0 if q == 2 else 1.3)  # FIFOs run full rate
        + P_ACCBUF * util
        + P_SRAM * 1.125
        + P_MCU
    )
    return DesignPoint(f"SA-SMT-T{t}Q{q}", speed, p)


def _f_w() -> float:
    """TPE buffer factor at the 50/50 anchor: 2x throughput, all MACs
    busy (+5% mux), SRAM streams 2x dense-equivalent data (weights
    DBB-compressed 5/8); TPE register file clocks at constant rate
    (intra-TPE operand/accumulator reuse — Table 1's 0.875 B/MAC)."""
    s = 2.0
    fixed = (
        P_MAC * 1.05 * _gate(R_GATE, 0.5)  # act zeros still ZVCG-gated
        + P_SRAM_W * dbb_stream_ratio(4) * s
        + P_SRAM_A * 1.0 * s
        + P_MCU
    )
    return (P_W_ANCHOR - fixed) / (P_OPBUF + P_ACCBUF)


F_W = _f_w()


def s2ta_w(d_w: float, d_a: float) -> DesignPoint:
    nnz_w = nnz_w_of(d_w)
    s = 2.0 if nnz_w <= 4 else 1.0
    p = (
        P_MAC * 1.05 * _gate(R_GATE, d_a)
        + (P_OPBUF + P_ACCBUF) * F_W
        + P_SRAM_W * dbb_stream_ratio(nnz_w) * s
        + P_SRAM_A * s
        + P_MCU
    )
    return DesignPoint("S2TA-W", s, p)


def _f_aw() -> float:
    """Time-unrolled TPE factor at the 50/50 anchor (speed 2, NNZ_a=4):
    buffers clock at CONSTANT per-cycle rate — serializing the block over
    time is precisely what keeps datapath utilization and operand
    bandwidth constant while density varies (paper §5.2); SRAM streams
    compressed on BOTH tensors at the effective rate."""
    s = 2.0
    fixed = (
        P_MAC * 1.05
        + P_SRAM_W * dbb_stream_ratio(4) * s
        + P_SRAM_A * dbb_stream_ratio(4) * s
        + P_DAP
        + P_MCU_TPE
    )
    return (P_AW_ANCHOR - fixed) / (P_OPBUF + P_ACCBUF)


F_AW = _f_aw()


def s2ta_aw(d_w: float, d_a: float) -> DesignPoint:
    nnz_a = nnz_a_of(d_a)
    nnz_w = nnz_w_of(d_w)
    s = min(8.0, 8.0 / nnz_a)
    p = (
        P_MAC * 1.05
        + (P_OPBUF + P_ACCBUF) * F_AW
        + P_SRAM_W * dbb_stream_ratio(nnz_w) * s
        + P_SRAM_A * dbb_stream_ratio(nnz_a) * s
        + P_DAP * (1.0 if nnz_a < 8 else 0.0)
        + P_MCU_TPE
    )
    return DesignPoint("S2TA-AW", s, p)


DESIGNS = {
    "sa": sa,
    "sa_zvcg": sa_zvcg,
    "sa_smt": sa_smt,
    "s2ta_w": s2ta_w,
    "s2ta_aw": s2ta_aw,
}


# ---------------------------------------------------------- layer / model


@dataclasses.dataclass
class LayerResult:
    layer: str
    design: str
    cycles: float
    time_s: float
    energy_mj: float
    power_mw: float
    speedup: float


def run_layer(design: str, layer: ConvLayer, **kw) -> LayerResult:
    dp = DESIGNS[design](layer.w_density, layer.a_density, **kw)
    cycles = layer.macs / N_MACS / dp.speedup
    t = cycles / F_CLK
    return LayerResult(
        layer=layer.name,
        design=dp.name,
        cycles=cycles,
        time_s=t,
        energy_mj=dp.power_mw * t * 1e3 / 1e3,  # mW * s -> uJ... keep mJ:
        power_mw=dp.power_mw,
        speedup=dp.speedup,
    )


def run_model(design: str, layers: Iterable[ConvLayer], **kw) -> dict:
    res: List[LayerResult] = [run_layer(design, l, **kw) for l in layers]
    t = sum(r.time_s for r in res)
    e = sum(r.power_mw * r.time_s for r in res)  # mW*s = mJ
    macs = sum(l.macs for l in layers)
    return {
        "design": design,
        "time_s": t,
        "energy_mj": e,
        "inf_per_s": 1.0 / t,
        "inf_per_j": 1.0 / (e / 1e3),
        "tops_eff": 2 * macs / t / 1e12,
        "tops_per_w": (2 * macs / t / 1e12) / (e / t / 1e3),
        "layers": res,
    }


# Table 1 (buffer bytes per MAC) — published values, used by benchmarks.
TABLE1_BUFFERS = {
    "SCNN": {"operands": 1280.0, "accumulators": 375.0},
    "SparTen": {"operands": 864.0, "accumulators": 128.0},
    "Eyeriss v2": {"operands": 165.0, "accumulators": 40.0},
    "SA-SMT": {"operands": 16.0, "accumulators": 4.0},
    "Systolic Array": {"operands": 2.0, "accumulators": 4.0},
    "S2TA-W": {"operands": 0.375, "accumulators": 0.5},
    "S2TA-AW": {"operands": 0.75, "accumulators": 4.0},
}

# Table 2 (S2TA-AW 16nm breakdown) — published values for comparison.
TABLE2_BREAKDOWN_MW = {
    "MAC Datapath and Buffers": 317.7,
    "Weight SRAM (512KB)": 69.4,
    "Activation SRAM (2MB)": 93.4,
    "Cortex-M33 MCU x4": 50.4,
    "DAP Array": 10.4,
}

# 65nm published comparison points (Fig. 12 / Table 4).
ENERGY_65NM_ALEXNET_UJ = {  # energy per inference, AlexNet conv
    "SparTen(45nm)": 1.0 / 0.52e3 * 1e6,  # 0.52e3 inf/J -> uJ/inf
    "Eyeriss v2": 1.0 / 0.74e3 * 1e6,
    "SA-ZVCG": 1.0 / 0.67e3 * 1e6,
    "S2TA-W": 1.0 / 0.66e3 * 1e6,
    "S2TA-AW": 1.0 / 1.02e3 * 1e6,
}


def model_breakdown(design: str, layer: ConvLayer, **kw) -> dict:
    """Component power split (mW) for Fig. 1 / Fig. 10 style plots."""
    d_w, d_a = layer.w_density, layer.a_density
    if design == "sa":
        return {
            "mac": P_MAC, "op_buf": P_OPBUF, "acc_buf": P_ACCBUF,
            "sram": P_SRAM, "mcu": P_MCU, "dap": 0.0,
        }
    if design == "sa_zvcg":
        daw = d_w * d_a
        return {
            "mac": P_MAC * _gate(R_GATE, daw),
            "op_buf": P_OPBUF * _gate(R_GATE, (d_w + d_a) / 2),
            "acc_buf": P_ACCBUF * _gate(R_GATE, daw),
            "sram": P_SRAM, "mcu": P_MCU, "dap": 0.0,
        }
    if design == "sa_smt":
        dp = sa_smt(d_w, d_a)
        util = min(1.0, dp.speedup * d_w * d_a)
        return {
            "mac": P_MAC * util,
            "op_buf": P_OPBUF * F_SMT,
            "acc_buf": P_ACCBUF * util,
            "sram": P_SRAM * 1.125, "mcu": P_MCU, "dap": 0.0,
        }
    if design == "s2ta_w":
        s = 2.0 if nnz_w_of(d_w) <= 4 else 1.0
        return {
            "mac": P_MAC * 1.05 * _gate(R_GATE, d_a),
            "op_buf": P_OPBUF * F_W,
            "acc_buf": P_ACCBUF * F_W,
            "sram": P_SRAM_W * dbb_stream_ratio(nnz_w_of(d_w)) * s + P_SRAM_A * s,
            "mcu": P_MCU, "dap": 0.0,
        }
    if design == "s2ta_aw":
        nnz_a, nnz_w = nnz_a_of(d_a), nnz_w_of(d_w)
        s = min(8.0, 8.0 / nnz_a)
        return {
            "mac": P_MAC * 1.05,
            "op_buf": P_OPBUF * F_AW,
            "acc_buf": P_ACCBUF * F_AW,
            "sram": P_SRAM_W * dbb_stream_ratio(nnz_w) * s
            + P_SRAM_A * dbb_stream_ratio(nnz_a) * s,
            "mcu": P_MCU_TPE, "dap": P_DAP if nnz_a < 8 else 0.0,
        }
    raise KeyError(design)
