"""The port's metrics (``paddle_tpu_torch.metric``) against the JAX
package's (``paddle_tpu.metric``) on the same seeded inputs: the same
names, ``compute`` / ``update`` results and counts exactly, ``accumulate``
to 1e-6, over several batches; the port takes torch tensors (bf16
included), the JAX package numpy."""
import numpy as np
import pytest
import torch

import paddle_tpu.metric as jmetric
import paddle_tpu_torch.metric as tmetric

ACC_TOL = 1e-6


def _batches(n=3, rows=32, classes=5, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, classes)).astype(np.float32),
             rng.integers(0, classes, (rows, 1)).astype(np.int64))
            for _ in range(n)]


def test_the_jax_module_names_are_there():
    for name in ("Metric", "Accuracy", "Precision", "Recall", "Auc",
                 "accuracy"):
        assert hasattr(tmetric, name), name
    assert set(tmetric.__all__) == {"Metric", "Accuracy", "Precision",
                                    "Recall", "Auc", "accuracy"}


@pytest.mark.parametrize("topk", [(1,), (1, 3)])
def test_accuracy_matches_jax(topk):
    """compute's top-k hits, update's batch accuracies, accumulate over
    three batches, reset."""
    got, want = tmetric.Accuracy(topk=topk), jmetric.Accuracy(topk=topk)
    assert got.name() == want.name() == "acc"
    for pred, label in _batches():
        c_got = got.compute(torch.from_numpy(pred), torch.from_numpy(label))
        c_want = want.compute(pred, label)
        np.testing.assert_array_equal(c_got.numpy(), c_want.numpy())
        assert got.update(c_got) == want.update(c_want)
    assert got.total == want.total and got.count == want.count
    np.testing.assert_allclose(got.accumulate(), want.accumulate(),
                               rtol=ACC_TOL)
    got.reset()
    assert got.accumulate() == (0.0 if len(topk) == 1 else [0.0, 0.0])


def test_accuracy_takes_bf16_and_flat_labels():
    """bf16 predictions (cast to f32 on the host) and (N,) labels give the
    JAX metric's counts on the f32 cast of the same values."""
    pred, label = _batches(1)[0]
    p16 = torch.from_numpy(pred).bfloat16()
    got, want = tmetric.Accuracy(), jmetric.Accuracy()
    got.update(got.compute(p16, torch.from_numpy(label[:, 0])))
    want.update(want.compute(p16.float().numpy(), label[:, 0]))
    assert got.total == want.total and got.count == want.count


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_match_jax(cls):
    rng = np.random.default_rng(1)
    got, want = getattr(tmetric, cls)(), getattr(jmetric, cls)()
    assert got.name() == want.name()
    assert got.accumulate() == want.accumulate() == 0.0
    for _ in range(4):
        preds = rng.random(64).astype(np.float32)
        labels = rng.integers(0, 2, 64).astype(np.int64)
        got.update(torch.from_numpy(preds), torch.from_numpy(labels))
        want.update(preds, labels)
    assert vars(got) == vars(want)
    np.testing.assert_allclose(got.accumulate(), want.accumulate(),
                               rtol=ACC_TOL)


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_matches_jax(two_columns):
    """The bucket counts exactly and the trapezoidal AUC to 1e-6, from
    one column of scores or from (N, 2) class probabilities."""
    rng = np.random.default_rng(2)
    got, want = tmetric.Auc(num_thresholds=255), jmetric.Auc(
        num_thresholds=255)
    assert got.accumulate() == want.accumulate() == 0.0
    for _ in range(3):
        p = rng.random(100).astype(np.float32)
        labels = (rng.random(100) < p).astype(np.int64)
        preds = np.stack([1 - p, p], 1) if two_columns else p
        got.update(torch.from_numpy(preds), torch.from_numpy(labels))
        want.update(preds, labels)
    np.testing.assert_array_equal(got._stat_pos, want._stat_pos)
    np.testing.assert_array_equal(got._stat_neg, want._stat_neg)
    np.testing.assert_allclose(got.accumulate(), want.accumulate(),
                               rtol=ACC_TOL)
    assert 0.5 < got.accumulate() <= 1.0


@pytest.mark.parametrize("k", [1, 2])
def test_functional_accuracy_matches_jax(k):
    for pred, label in _batches(2, seed=k):
        got = tmetric.accuracy(torch.from_numpy(pred),
                               torch.from_numpy(label), k=k)
        want = jmetric.accuracy(pred, label, k=k)
        assert got.dtype == torch.float32 and got.ndim == 0
        assert float(got) == float(np.asarray(want.numpy()))


def test_base_metric_contract():
    """The base class's abstract methods raise; ``compute`` passes its
    arguments through; ``name`` is the lowercased class name."""
    for m in (tmetric.Metric(), jmetric.Metric()):
        for fn in (m.reset, m.update, m.accumulate):
            with pytest.raises(NotImplementedError):
                fn()
        assert m.compute(1, 2) == (1, 2)
        assert m.name() == "metric"
    assert tmetric.Precision(name="p").name() == "p"
