"""Copy-on-write paged KV under mutable tensors.

The JAX store relies on immutability twice: free pages alias one zero
template, and a CoW copy is an alias until a functional update rebuilds the
buffer.  The port writes fragments in place, so these tests check that
forked ensemble members that diverge never see each other's writes, that
the prefill's own values survive, and that the template stays zero.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.serve import engine
from repro_torch.serve.kv import PagedKVStore

PS, MAX_LEN = 4, 16


@pytest.fixture()
def setup():
    cfg = get_smoke("qwen2_1_5b")
    store = PagedKVStore.for_model(cfg, page_size=PS, num_pages=32,
                                   max_len=MAX_LEN, device="cpu")
    return cfg, store


def _random_cache(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    c = engine.init_cache(cfg, 1, MAX_LEN, device="cpu")
    return [{k: torch.randn(v.shape, generator=g) for k, v in grp.items()}
            for grp in c["layers"]]


def _k(layers):
    return layers[0]["k"]


def test_fork_then_diverge_is_independent(setup):
    cfg, store = setup
    S, E = 7, 3
    prefill = _random_cache(cfg, 0)
    bt = store.alloc(0, owner="req")
    store.absorb(bt, prefill, 0, S, owner="req")
    members = [store.fork(bt) for _ in range(E)]
    store.free(bt)
    writes = []
    for m, mt in enumerate(members):
        # each member rewrites position S-1 (shared page -> CoW) and extends
        # past the prefill (fresh page) with its own values
        own = _random_cache(cfg, 100 + m)
        store.absorb(mt, own, S - 1, S + 3, owner="req")
        writes.append(own)
    for m, mt in enumerate(members):
        got = _k(store.materialize_layers(mt))
        np.testing.assert_array_equal(got[:, :, :S - 1],
                                      _k(prefill)[:, :, :S - 1])
        np.testing.assert_array_equal(got[:, :, S - 1:S + 3],
                                      _k(writes[m])[:, :, S - 1:S + 3])
        assert not got[:, :, S + 3:].any()
    # the shared prefix page is still shared, the rewritten page was copied
    assert members[0].pages[0] == members[1].pages[0]
    assert len({mt.pages[1] for mt in members}) == E
    assert store.stats.cow_copies >= E - 1
    store.assert_balanced(members)
    # the zero template and the never-written free pages stay zero
    assert not _k(store._template).any()
    used = {p for mt in members for p in mt.pages}
    for pid in range(store.pool.num_pages):
        if pid not in used:
            assert store._frags[pid] is store._template


def test_materialize_never_aliases_a_page(setup):
    """The gathered cache is a new tensor even when one page covers the
    whole sequence, so in-place engine writes cannot reach the pages."""
    cfg = setup[0]
    store = PagedKVStore.for_model(cfg, page_size=MAX_LEN, num_pages=2,
                                   max_len=MAX_LEN, device="cpu")
    bt = store.alloc(0, owner=0)
    store.absorb(bt, _random_cache(cfg, 1), 0, 5, owner=0)
    before = _k(store.materialize_layers(bt)).clone()
    gathered = store.materialize_layers(bt)
    with torch.inference_mode():                 # as the engine writes
        _k(gathered).fill_(7.0)
    np.testing.assert_array_equal(_k(store.materialize_layers(bt)), before)
    store.free(bt)
    assert not _k(store._template).any()
    assert store._frags[bt.pages[0]] is store._template
