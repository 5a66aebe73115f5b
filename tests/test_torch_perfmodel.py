"""Port parity, the S2TA performance model: ``repro_torch.perfmodel``
(the port's own copy, plain Python) equals ``repro.perfmodel`` on every
design point, every layer of every model in ``MODELS``, ``typical_conv``
and ``model_breakdown``; and the reference's published-number and
property assertions (``tests/test_perfmodel.py``) hold for the port's
copy, one parametrised case each."""

import dataclasses

import pytest

from _hypo import given, settings, st  # hypothesis-or-skip shim

from repro.perfmodel import s2ta as j_s2ta
from repro.perfmodel import workloads as j_wl
from repro_torch.perfmodel import s2ta
from repro_torch.perfmodel.workloads import MODELS, typical_conv

DENSITIES = [(0.5, 0.5), (0.25, 0.25), (0.5, 0.125), (0.5, 1.0), (0.5, 0.75), (0.6, 0.5),
             (0.375, 0.625), (1.0, 1.0), (0.125, 0.05)]


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def test_module_constants_equal():
    for name in ("F_SMT", "F_W", "F_AW", "TABLE1_BUFFERS", "TABLE2_BREAKDOWN_MW"):
        assert getattr(s2ta, name) == getattr(j_s2ta, name), name
    assert sorted(s2ta.DESIGNS) == sorted(j_s2ta.DESIGNS)


@pytest.mark.parametrize("design", sorted(j_s2ta.DESIGNS))
@pytest.mark.parametrize("d_w,d_a", DENSITIES)
def test_design_point_equals_reference(design, d_w, d_a):
    assert _asdict(s2ta.DESIGNS[design](d_w, d_a)) == _asdict(j_s2ta.DESIGNS[design](d_w, d_a))


@pytest.mark.parametrize("model", sorted(j_wl.MODELS))
def test_workloads_equal_reference(model):
    assert [_asdict(l) for l in MODELS[model]] == [_asdict(l) for l in j_wl.MODELS[model]]


@pytest.mark.parametrize("design", sorted(j_s2ta.DESIGNS))
@pytest.mark.parametrize("model", sorted(j_wl.MODELS))
def test_run_model_and_layers_equal_reference(design, model):
    mine, ref = s2ta.run_model(design, MODELS[model]), j_s2ta.run_model(design, j_wl.MODELS[model])
    assert [_asdict(r) for r in mine.pop("layers")] == [_asdict(r) for r in ref.pop("layers")]
    assert mine == ref
    for mine, ref in zip(MODELS[model], j_wl.MODELS[model]):
        assert _asdict(s2ta.run_layer(design, mine)) == _asdict(j_s2ta.run_layer(design, ref))


@pytest.mark.parametrize("design", sorted(j_s2ta.DESIGNS))
@pytest.mark.parametrize("w_d,a_d", [(4 / 8, 3 / 8), (0.5, 0.5), (0.5, 0.625)])
def test_typical_conv_and_breakdown_equal_reference(design, w_d, a_d):
    assert _asdict(typical_conv(w_d, a_d)) == _asdict(j_wl.typical_conv(w_d, a_d))
    assert (s2ta.model_breakdown(design, typical_conv(w_d, a_d))
            == j_s2ta.model_breakdown(design, j_wl.typical_conv(w_d, a_d)))


@pytest.mark.parametrize("nnz", range(1, 9))
def test_helpers_equal_reference(nnz):
    assert s2ta.dbb_stream_ratio(nnz) == j_s2ta.dbb_stream_ratio(nnz)
    d = nnz / 8
    assert s2ta.nnz_a_of(d) == j_s2ta.nnz_a_of(d)
    assert s2ta.nnz_w_of(d) == j_s2ta.nnz_w_of(d)


# ------------------------------------ the reference's assertions, on the port


def _anchor_tops_per_w():
    assert abs(s2ta.sa_zvcg(0.5, 0.5).tops_per_w - 10.5) < 0.2
    assert abs(s2ta.sa_smt(0.5, 0.5).tops_per_w - 8.01) < 0.2
    assert abs(s2ta.s2ta_w(0.5, 0.5).tops_per_w - 12.4) < 0.3
    assert abs(s2ta.s2ta_aw(0.5, 0.5).tops_per_w - 14.3) < 0.3


def _anchor_75_crossvalidation():
    got = s2ta.s2ta_aw(0.25, 0.25).tops_per_w
    assert abs(got - 26.5) / 26.5 < 0.10, got


def _zvcg_25pct_below_dense():
    e_sa = s2ta.sa(0.5, 0.5).power_mw
    e_zv = s2ta.sa_zvcg(0.5, 0.5).power_mw
    assert abs(1 - e_zv / e_sa - 0.25) < 0.02


def _smt_speedup_fig3():
    assert abs(s2ta.sa_smt(0.5, 0.5, q=2).speedup - 1.6) < 0.05
    assert abs(s2ta.sa_smt(0.5, 0.5, q=4).speedup - 1.8) < 0.05


def _smt_energy_worse_than_zvcg():
    lay = typical_conv(0.5, 0.375)
    z = s2ta.run_layer("sa_zvcg", lay)
    m = s2ta.run_layer("sa_smt", lay)
    assert m.power_mw * m.time_s > 1.15 * z.power_mw * z.time_s


def _aw_peak_speedup_8x():
    assert s2ta.s2ta_aw(0.5, 0.125).speedup == 8.0
    assert s2ta.s2ta_aw(0.5, 1.0).speedup == 1.0
    assert s2ta.s2ta_aw(0.5, 0.75).speedup == 1.0


def _w_speedup_step_at_half():
    assert s2ta.s2ta_w(0.5, 0.5).speedup == 2.0
    assert s2ta.s2ta_w(0.6, 0.5).speedup == 1.0


def _headline_model_ratios():
    es, ss, ew, esm = [], [], [], []
    for layers in MODELS.values():
        zv = s2ta.run_model("sa_zvcg", layers)
        aw = s2ta.run_model("s2ta_aw", layers)
        w = s2ta.run_model("s2ta_w", layers)
        sm = s2ta.run_model("sa_smt", layers)
        es.append(zv["energy_mj"] / aw["energy_mj"])
        ss.append(zv["time_s"] / aw["time_s"])
        ew.append(w["energy_mj"] / aw["energy_mj"])
        esm.append(sm["energy_mj"] / aw["energy_mj"])

    def avg(xs):
        return sum(xs) / len(xs)

    assert 1.5 <= avg(es) <= 2.6, avg(es)
    assert 1.7 <= avg(ss) <= 3.2, avg(ss)
    assert 1.3 <= avg(ew) <= 2.3, avg(ew)
    assert 1.8 <= avg(esm) <= 2.9, avg(esm)


def _table1_ordering():
    t = s2ta.TABLE1_BUFFERS

    def tot(k):
        return t[k]["operands"] + t[k]["accumulators"]

    assert tot("S2TA-W") < tot("Systolic Array") < tot("SA-SMT") \
        < tot("Eyeriss v2") < tot("SparTen") < tot("SCNN")
    assert tot("SCNN") / tot("S2TA-W") > 1800


def _table2_total_power():
    bd = s2ta.model_breakdown("s2ta_aw", typical_conv(0.5, 0.5))
    assert abs(sum(bd.values()) - 541.3) / 541.3 < 0.05


PUBLISHED = [_anchor_tops_per_w, _anchor_75_crossvalidation, _zvcg_25pct_below_dense,
             _smt_speedup_fig3, _smt_energy_worse_than_zvcg, _aw_peak_speedup_8x,
             _w_speedup_step_at_half, _headline_model_ratios, _table1_ordering,
             _table2_total_power]


@pytest.mark.parametrize("check", PUBLISHED, ids=lambda f: f.__name__.lstrip("_"))
def test_published_numbers_hold_for_port(check):
    check()


@given(d_w=st.floats(0.05, 1.0), d_a=st.floats(0.05, 1.0))
@settings(max_examples=60, deadline=None)
def test_prop_port_equals_reference_and_bounded(d_w, d_a):
    for d in s2ta.DESIGNS:
        dp = s2ta.DESIGNS[d](d_w, d_a)
        assert _asdict(dp) == _asdict(j_s2ta.DESIGNS[d](d_w, d_a))
        assert 0 < dp.power_mw < 2000
        assert 1.0 <= dp.speedup <= 8.0


@given(d_a=st.floats(0.05, 0.62))
@settings(max_examples=30, deadline=None)
def test_prop_aw_energy_improves_with_act_sparsity(d_a):
    def e(layer):
        r = s2ta.run_layer("s2ta_aw", layer)
        return r.power_mw * r.time_s

    assert e(typical_conv(0.5, d_a)) <= e(typical_conv(0.5, 0.625)) * 1.001


@given(d_w=st.floats(0.05, 1.0), d_a=st.floats(0.05, 1.0))
@settings(max_examples=30, deadline=None)
def test_prop_zvcg_power_monotone_in_density(d_w, d_a):
    p = s2ta.sa_zvcg(d_w, d_a).power_mw
    p_denser = s2ta.sa_zvcg(min(1.0, d_w + 0.1), min(1.0, d_a + 0.1)).power_mw
    assert p <= p_denser + 1e-9


@given(nnz=st.integers(1, 8))
@settings(max_examples=8, deadline=None)
def test_prop_stream_ratio(nnz):
    r = s2ta.dbb_stream_ratio(nnz)
    assert 0 < r <= 1
    if nnz < 8:
        assert r == (nnz + 1) / 8
