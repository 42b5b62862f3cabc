"""Host-side parity of the PyTorch port: the numpy/float64 code it carries
over from ``repro`` (data synthesis, partitioners, shard sampling, request
patterns, coding matrices, error localization) must give the same bytes as
the reference for the same seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coding as jcoding
from repro.core import sharding as jsharding
from repro.data import federated as jfed
from repro.data import synthetic as jsyn
from repro_torch.core import coding as tcoding
from repro_torch.core import sharding as tsharding
from repro_torch.data import federated as tfed
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)


@pytest.mark.parametrize("n,size,channels,noise,seed", [
    (50, 8, 1, 0.25, 0), (30, 12, 3, 0.35, 7), (17, 28, 1, 0.0, 3)])
def test_synthetic_images_identical(n, size, channels, noise, seed):
    a = jsyn.make_image_data(n, image_size=size, channels=channels,
                             noise=noise, seed=seed)
    b = tsyn.make_image_data(n, image_size=size, channels=channels,
                             noise=noise, seed=seed)
    assert a.images.dtype == b.images.dtype and a.labels.dtype == b.labels.dtype
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("name,kwargs", [
    ("iid", {}), ("primary-class", {}), ("buckets", {}),
    ("dirichlet", {"alpha": 0.3}), ("zipf", {"exponent": 0.8})])
@pytest.mark.parametrize("seed", [0, 5])
def test_partitioners_identical(name, kwargs, seed):
    labels = jsyn.make_image_data(240, image_size=8, seed=seed).labels
    a = jfed.get_partitioner(name, **kwargs)(240, labels, 12, seed)
    b = tfed.get_partitioner(name, **kwargs)(240, labels, 12, seed)
    assert sorted(jfed.PARTITIONERS) == sorted(tfed.PARTITIONERS)
    assert len(a) == len(b) == 12
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_shard_manager_plans_identical():
    ja = jsharding.ShardManager(100, 4, 20, seed=3)
    ta = tsharding.ShardManager(100, 4, 20, seed=3)
    for _ in range(3):
        jp, tp = ja.new_stage(), ta.new_stage()
        assert jp.stage == tp.stage
        assert jp.shard_clients == tp.shard_clients
        assert jp.clients == tp.clients
        victims = [jp.clients[0], jp.clients[7]]
        assert ja.impacted_shards(jp, victims) == ta.impacted_shards(tp, victims)
        for s in jp.shard_clients:
            assert ja.retained(jp, s, victims) == ta.retained(tp, s, victims)


@pytest.mark.parametrize("k,seed", [(1, 0), (4, 1), (6, 2)])
def test_request_patterns_identical(k, seed):
    jp = jsharding.ShardManager(40, 4, 20, seed=seed).new_stage()
    tp = tsharding.ShardManager(40, 4, 20, seed=seed).new_stage()
    assert jsharding.even_requests(jp, k, seed) == \
        tsharding.even_requests(tp, k, seed)
    assert jsharding.adaptive_requests(jp, k, seed) == \
        tsharding.adaptive_requests(tp, k, seed)


@pytest.mark.parametrize("c,s", [(20, 4), (8, 2), (100, 4), (5, 5)])
def test_coding_matrices_identical(c, s):
    js_, ts_ = jcoding.CodingScheme(s, c), tcoding.CodingScheme(s, c)
    np.testing.assert_array_equal(js_.alpha, ts_.alpha)
    np.testing.assert_array_equal(js_.omega, ts_.omega)
    np.testing.assert_array_equal(js_.encode_matrix(), ts_.encode_matrix())
    rng = np.random.default_rng(c)
    for ids in (list(range(c)), sorted(rng.choice(c, size=s, replace=False)),
                sorted(rng.choice(c, size=min(c, s + 2), replace=False))):
        dj, ij = js_.decode_matrix(ids)
        dt, it = ts_.decode_matrix(ids)
        np.testing.assert_array_equal(dj, dt)
        np.testing.assert_array_equal(ij, it)
        np.testing.assert_array_equal(js_.quorum(ids), ts_.quorum(ids))
        rj, rt = js_.reduced(ids), ts_.reduced(ids)
        np.testing.assert_array_equal(rj.alpha, rt.alpha)
        np.testing.assert_array_equal(rj.encode_matrix(), rt.encode_matrix())
        assert rj.max_errors == rt.max_errors
    np.testing.assert_array_equal(js_.quorum(), ts_.quorum())
    assert js_.max_errors == ts_.max_errors


def _corrupted(bad, p=96, scale=10.0, seed=0, c=20, s=4):
    """The corruption cases of tests/test_coding.py, built once in numpy and
    handed to both packages."""
    sch = jcoding.CodingScheme(num_shards=s, num_clients=c)
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((s, p)), jnp.float32)
    slices = np.array(jcoding.encode(sch, w), np.float64)
    slices[bad] += rng.standard_normal((len(bad), p)) * scale
    return slices


@pytest.mark.parametrize("method", ["bw", "ransac"])
@pytest.mark.parametrize("bad,seed", [
    ([0, 4, 9, 13, 17], 0), ([2, 6, 10, 15], 2), ([], 1),
    ([1, 3, 5, 7, 11, 14, 16, 19], 3)])
def test_locate_errors_identical(method, bad, seed):
    slices = _corrupted(bad, seed=seed)
    a = jcoding.locate_errors(jcoding.CodingScheme(4, 20), slices,
                              method=method)
    b = tcoding.locate_errors(tcoding.CodingScheme(4, 20), slices,
                              method=method)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_locate_errors_budget_exceeded_identical():
    slices = _corrupted(list(range(0, 20, 2)), seed=4)
    with pytest.raises(jcoding.CodingBudgetExceeded) as ej:
        jcoding.locate_errors(jcoding.CodingScheme(4, 20), slices)
    with pytest.raises(tcoding.CodingBudgetExceeded) as et:
        tcoding.locate_errors(tcoding.CodingScheme(4, 20), slices)
    assert (ej.value.observed, ej.value.max_errors) == \
        (et.value.observed, et.value.max_errors)
