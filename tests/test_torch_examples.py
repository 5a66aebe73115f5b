"""The port's four examples (``examples/*_torch.py``) on the CPU.

The CNN of the paper's Table 3 (``examples/cnn_dap_finetune_torch.py``)
is held against the code ``examples/cnn_dap_finetune.py`` runs,
``benchmarks/table3_accuracy.py``, imported read-only as the oracle:
the reference's ``init_cnn(PRNGKey(0))`` crosses over through
``convert.params_from_numpy`` and both sides read the same
``SyntheticVision`` batches.  Tolerances, from the f32 arithmetic: the
convolutions sum 72 and 144 products a output in XLA's order and
oneDNN's, which differ by about 3e-7 of the logits' scale here, so

* logits within 1e-5 of their largest magnitude, the loss within 1e-6
  relative;
* gradients and the parameters after 5 ``train_step`` calls within 1e-5
  of each leaf's largest magnitude (measured: 1.4e-6 and 2e-7);
* the DAP selections, the W-DBB pruning and masks bit for bit (they
  decide on equal values);
* ``run(30, 15)``'s rows within 2 / 5120 each, two of the 5120 held-out
  predictions (an argmax flips only at a near-tie of logits that agree
  to 1e-6; measured equal).

The other three examples run their ``main`` under ``--device cpu`` at
their small sizes; every example raises without a card unless asked
for the CPU, and none imports JAX or the reference.
"""

import ast
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dbb as jdbb
from repro.core import schedule as jschedule
from repro_torch import convert
from repro_torch.data.pipeline import SyntheticVision

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart_torch", "serve_packed_torch", "train_e2e_torch", "cnn_dap_finetune_torch")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ex = {name: _load(f"_example_{name}", ROOT / "examples" / f"{name}.py") for name in EXAMPLES}
tc = ex["cnn_dap_finetune_torch"]
jt = _load("_reference_table3_accuracy", ROOT / "benchmarks" / "table3_accuracy.py")

# (W-DBB pruned and masked, DAP nnz) of the train_step modes, and the
# forward's extra DAP 2/8 of the no-finetune row
MODES = {"dense": (False, None), "wdbb": (True, None), "dap4": (False, 4), "awdbb4": (True, 4)}
FORWARD_MODES = dict(MODES, dap2=(False, 2))


def _reference_start(wdbb):
    """The reference's init (pruned and masked as its run does when
    ``wdbb``) and the port's converted copy: ``(jparams, jmasks, tparams,
    tmasks)``."""
    jp = jt.init_cnn(jax.random.PRNGKey(0))
    jm = None
    if wdbb:
        pred = lambda path, w: "c1" not in "/".join(str(getattr(k, "key", k)) for k in path)
        jp = jschedule.prune_weights(jp, jdbb.DBBConfig(4, 8), predicate=pred)
        jm = jschedule.wdbb_masks(jp, jdbb.DBBConfig(4, 8), predicate=pred)
    raw = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jt.init_cnn(
        jax.random.PRNGKey(0))))
    tp, tm = tc.prepare(raw, wdbb)
    return jp, jm, tp, tm


def _close(got, want, bound, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound * scale, f"{what}: {err:.3g} of a scale {scale:.3g}"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax(name):
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), f"{name}: imports {n}"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name, monkeypatch):
    """Without a card and without ``--device cpu`` each example raises;
    there is no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex[name].main([])


# ------------------------------------------------------------------ the CNN


@pytest.mark.parametrize("mode", FORWARD_MODES)
def test_cnn_forward_loss_and_gradients_match_reference(mode):
    """Logits, loss, accuracy and the three gradients on the converted
    init, W-DBB pruned where the mode says, DAP at the input (K = 8) and
    after the first pool (K = 16)."""
    wdbb, a_nnz = FORWARD_MODES[mode]
    jp, jm, tp, tm = _reference_start(wdbb)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))  # pruning bit for bit
        if wdbb:
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    raw = next(SyntheticVision(jt.N_CLASSES, jt.IMG, batch=128, seed=0))
    batch = tc.to_batch(raw, "cpu")
    _close(tc.forward(tp, batch["x"], a_nnz).detach(), jt.forward(jp, jnp.asarray(raw["x"]), a_nnz),
           1e-5, "logits")
    (jce, jacc), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(jp, raw, a_nnz)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    ce, acc = tc.loss_fn(leaves, batch, a_nnz)
    grads = torch.autograd.grad(ce, list(leaves.values()))
    np.testing.assert_allclose(float(ce.detach()), float(jce), rtol=1e-6)
    assert float(acc) == float(jacc)
    for (k, _), g in zip(leaves.items(), grads):
        _close(g, jg[k], 1e-5, f"gradient of {k}")


@pytest.mark.parametrize("mode", MODES)
def test_cnn_train_steps_match_reference(mode):
    """Five ``train_step`` calls of each mode (SGD at lr 1e-2, the masks
    re-applied after each) from the converted init on the same batches."""
    wdbb, a_nnz = MODES[mode]
    jp, jm, tp, tm = _reference_start(wdbb)
    data = SyntheticVision(jt.N_CLASSES, jt.IMG, batch=128, seed=0)
    for _ in range(5):
        raw = next(data)
        jp, jce, _ = jt.train_step(jp, raw, jm, a_nnz=a_nnz)
        tp, ce, _ = tc.train_step(tp, tc.to_batch(raw, "cpu"), tm, a_nnz)
        np.testing.assert_allclose(float(ce), float(jce), rtol=1e-6)
    for k in jp:
        _close(tp[k], jp[k], 1e-5, f"{mode} {k} after 5 steps")
        if wdbb:  # the masked entries stay exactly zero
            assert not tp[k][~tm[k]].any()


def test_cnn_run_rows_match_reference():
    """``run(steps_base=30, steps_ft=15)``: the five rows and the joint
    delta, from the converted init; the port's run checks the W-DBB bound
    on ``d`` after the joint fine-tune (it raises otherwise)."""
    jrows, jderived = jt.run(steps_base=30, steps_ft=15, seed=0)
    init = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jt.init_cnn(
        jax.random.PRNGKey(0))))
    rows, derived = tc.run(30, 15, 0, "cpu", params=init)
    assert [r["config"] for r in rows] == [r["config"] for r in jrows]
    for r, jr in zip(rows, jrows):
        assert abs(r["acc"] - jr["acc"]) <= 2 / 5120, (r, jr)
    assert abs(derived - jderived) <= 2 / 5120
    assert rows[0]["acc"] > 0.5  # the baseline learned the task


def test_cnn_main_on_cpu(capsys):
    """The example's entry point on the CPU: its own seeded init, the
    table printed in the reference example's layout."""
    rows, _ = tc.main(["--device", "cpu", "--steps-base", "3", "--steps-ft", "2"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "joint A/W-DBB vs baseline" in out
    assert [r["config"] for r in rows] == ["baseline (dense)", "A-DBB 2/8 no-finetune"] + [
        name for name, _, _ in tc.FINE_TUNES]


# -------------------------------------------------------- the other three


def test_quickstart_main_smoke_on_cpu(capsys):
    """The six sections with ``--smoke``; section 5 (kernel #1 against its
    plain version) says it needs the card and runs nothing."""
    logits = ex["quickstart_torch"].main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "needs the card" in out and out.rstrip().endswith("quickstart OK")
    assert tuple(logits.shape) == (2, 8, 256) and bool(torch.isfinite(logits).all())


def test_serve_packed_main_on_cpu():
    """Dense, packed and int8-wire serving of the W-DBB-pruned smoke
    granite (the example itself asserts packed == dense and int8-KV
    batched == stepped); the int8 KV cache takes fewer bytes than f32."""
    res = ex["serve_packed_torch"].main(["--device", "cpu"])
    np.testing.assert_array_equal(res["packed"], res["dense"])
    np.testing.assert_array_equal(res["kv_batched"], res["kv_stepped"])
    kv_f, kv_8 = res["kv_bytes"]
    assert res["dense"].shape == (4, 28) and kv_8 < kv_f / 3


def test_train_e2e_main_tiny_on_cpu(tmp_path):
    """Dense warmup (steps 0-1), the W-DBB ramp to 4/8 by step 10, the
    masks refreshed there, DAP throughout, checkpoints at 10 and 20, and a
    new trainer resuming at step 20."""
    res = ex["train_e2e_torch"].main(["--tiny", "--steps", "20", "--device", "cpu",
                                      "--ckpt-dir", str(tmp_path)])
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert res["wdbb_ok"] and res["resumed_step"] == 20
