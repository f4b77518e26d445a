"""ray_tpu_torch.serve against ray_tpu.serve on the CPU: the port's
LLMServer on converted gpt_nano weights returns the JAX LLMServer's tokens,
and the KV-pool, lease, prefix-cache and bitwise properties of
tests/test_llm.py hold on the port.

Both servers run in float32 with the settings of tests/test_llm.py. Token
ids must be equal; logits agree within atol 2e-5, rtol 1e-4 (float32, other
summation orders); cached-vs-uncached logits on one server must be bitwise
equal.
"""

import gc
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from ray_tpu.serve import batching as jbatching
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import convert, gpt
from ray_tpu_torch.models.inference import make_forward
from ray_tpu_torch.serve import BackPressureError, batching, llm

CFG = gpt.gpt_nano()
SETTINGS = dict(
    num_blocks=64, block_size=16, prefill_lanes=2, lane_buckets=(1, 2, 4),
    prefill_token_buckets=(16, 32), cache_buckets=(64, 128),
)
TOL = dict(atol=2e-5, rtol=1e-4)

_AD = llm.random_lora(CFG, rank=4, seed=3, scale=4.0)
_ADAPTERS = {"lora:a": (_AD["A"], _AD["B"], _AD["scale"])}


def _prompt(seed: int, n: int):
    return [int(t) for t in np.random.RandomState(seed).randint(0, CFG.vocab_size, n)]


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jllm.make_params(seed=0))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return convert.params_from_jax(jax_params, CFG, device="cpu")


@pytest.fixture(scope="module")
def jax_server(jax_params):
    srv = jllm.LLMServer(None, params=jax_params, prefix_caching=True,
                         adapter_loader=lambda mid: _ADAPTERS[mid], **SETTINGS)
    yield srv
    jbatching.shutdown_batchers(srv)


@pytest.fixture(scope="module")
def port_server(port_params):
    srv = llm.LLMServer(CFG, params=port_params, device="cpu",
                        prefix_caching=True,
                        adapter_loader=lambda mid: _ADAPTERS[mid], **SETTINGS)
    yield srv
    srv.close()


# ---------------------------------------------------------------------------
# the slice: same tokens as the JAX server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_id", [None, "lora:a"])
@pytest.mark.parametrize("seed,n", [(10, 24), (11, 40), (12, 57)])
def test_tokens_match_jax_server(jax_server, port_server, seed, n, model_id):
    payload = {"prompt": _prompt(seed, n), "max_new_tokens": 6,
               "return_logits": True, "model_id": model_id}
    ref = jax_server(dict(payload))
    out = port_server(dict(payload))
    assert out["tokens"] == ref["tokens"]
    np.testing.assert_allclose(out["logits"], np.asarray(ref["logits"]), **TOL)
    for key in ("prefix_cached_tokens", "prefill_tokens", "model_id"):
        assert out[key] == ref[key]


def test_first_token_matches_full_forward(port_server, port_params):
    prompt = _prompt(0, 24)
    r = port_server({"prompt": prompt, "max_new_tokens": 1})
    ref = make_forward(CFG, "cpu")(port_params, torch.tensor([prompt]))
    assert r["tokens"][0] == int(ref[0, -1].argmax())


# ---------------------------------------------------------------------------
# KV block pool: refcounts, exactly-once leases, copy-on-write
# ---------------------------------------------------------------------------


def test_kv_pool_lives_on_the_device_in_the_compute_dtype():
    pool = llm.KVBlockPool(CFG, num_blocks=8, block_size=4, device="cpu")
    assert pool.k_data.shape == (8, CFG.num_layers, 4, CFG.num_heads, CFG.head_dim)
    assert pool.k_data.dtype == CFG.dtype and pool.k_data.device.type == "cpu"


def test_kv_pool_allocate_free_refcounts():
    pool = llm.KVBlockPool(CFG, num_blocks=8, block_size=4, device="cpu")
    a = pool.allocate(3)
    assert pool.in_use() == 3
    pool.incref(a[:1])
    pool.free(a)
    assert pool.in_use() == 1
    pool.free(a[:1])
    assert pool.in_use() == 0
    with pytest.raises(llm.NoKVBlocksError):
        pool.allocate(9)
    assert pool.in_use() == 0


def test_kv_lease_releases_exactly_once():
    pool = llm.KVBlockPool(CFG, num_blocks=8, block_size=4, device="cpu")
    lease = llm.KVLease(pool)
    lease.add(pool.allocate(4))
    before = pool.freed_total
    for _ in range(5):
        lease.release()
    assert pool.in_use() == 0
    assert pool.freed_total == before + 4
    lease.add(pool.allocate(1))  # a straggler add after release must not leak
    assert pool.in_use() == 0


def test_kv_pool_copy_on_write():
    pool = llm.KVBlockPool(CFG, num_blocks=8, block_size=4, device="cpu")
    (shared,) = pool.allocate(1)
    pool.k_data[shared][:] = 7.0
    pool.incref([shared])
    blocks = [shared]
    new = pool.ensure_private(blocks, 0)
    assert new != shared and blocks[0] == new
    assert torch.all(pool.k_data[new] == 7.0)
    assert pool.refcount(shared) == 1
    pool.k_data[new][:] = 9.0
    assert torch.all(pool.k_data[shared] == 7.0)
    assert pool.ensure_private(blocks, 0) == new


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------


def test_chain_hashes_match_the_reference():
    p = _prompt(20, 50)
    assert llm.chain_hashes(p, 16) == jllm.chain_hashes(p, 16)
    a = llm.chain_hashes([1, 2, 3, 4, 5, 6, 7, 8, 9], 4)
    b = llm.chain_hashes([1, 2, 3, 4, 5, 6, 7, 99], 4)
    c = llm.chain_hashes([9, 2, 3, 4, 5, 6, 7, 8], 4)
    assert a[0] == b[0] and a[1] != b[1]
    assert c[0] != a[0] and c[1] != a[1]


def test_prefix_cache_match_insert_evict():
    pool = llm.KVBlockPool(CFG, num_blocks=4, block_size=4, device="cpu")
    cache = llm.PrefixCache(pool)
    hashes = llm.chain_hashes(list(range(8)), 4)
    blocks = pool.allocate(2)
    cache.insert(hashes, blocks)
    assert pool.refcount(blocks[0]) == 2
    got = cache.match(hashes)
    assert got == blocks and cache.hits == 2
    pool.free(got)
    pool.free(blocks)
    assert pool.in_use() == 2
    more = pool.allocate(4)
    assert len(more) == 4 and len(cache) == 0 and cache.evictions == 2


def test_prefix_cache_hits_skip_prefill_and_decode_bitwise(port_server):
    srv = port_server
    prompt = _prompt(1, 40)
    s0 = srv.kv_stats()
    r1 = srv({"prompt": prompt, "max_new_tokens": 6, "return_logits": True})
    assert r1["prefix_cached_tokens"] == 0 and r1["prefill_tokens"] == 40
    reqs = [srv({"prompt": prompt, "max_new_tokens": 6, "return_logits": True})
            for _ in range(3)]
    assert srv.kv_stats()["prefix_hits"] > s0["prefix_hits"]
    for r in reqs:
        assert r["prefix_cached_tokens"] == 32 and r["prefill_tokens"] == 8
        assert r["tokens"] == r1["tokens"]
        assert np.array_equal(r["logits"], r1["logits"])


def test_prefix_cached_decode_matches_cacheless_engine(port_server, port_params):
    prompt = _prompt(2, 33)
    warm = port_server({"prompt": prompt, "max_new_tokens": 4, "return_logits": True})
    hit = port_server({"prompt": prompt, "max_new_tokens": 4, "return_logits": True})
    assert hit["prefix_cached_tokens"] > 0
    plain = llm.LLMServer(CFG, params=port_params, device="cpu",
                          prefix_caching=False, **SETTINGS)
    try:
        ref = plain({"prompt": prompt, "max_new_tokens": 4, "return_logits": True})
        assert ref["prefix_cached_tokens"] == 0
        assert np.array_equal(hit["logits"], ref["logits"])
        assert hit["tokens"] == ref["tokens"] == warm["tokens"]
    finally:
        plain.close()


def test_divergent_suffix_invalidates_correctly(port_server):
    system = _prompt(3, 32)
    pa, pb = system + _prompt(4, 8), system + _prompt(5, 8)
    ra1 = port_server({"prompt": pa, "max_new_tokens": 5})
    rb1 = port_server({"prompt": pb, "max_new_tokens": 5})
    ra2 = port_server({"prompt": pa, "max_new_tokens": 5})
    rb2 = port_server({"prompt": pb, "max_new_tokens": 5})
    assert ra2["prefix_cached_tokens"] >= 32 and rb2["prefix_cached_tokens"] >= 32
    assert ra1["tokens"] != rb1["tokens"]
    assert ra1["tokens"] == ra2["tokens"] and rb1["tokens"] == rb2["tokens"]


# ---------------------------------------------------------------------------
# LoRA multiplexing
# ---------------------------------------------------------------------------


def test_lora_adapter_changes_tokens(port_server):
    prompt = _prompt(6, 24)
    base = port_server({"prompt": prompt, "max_new_tokens": 6})
    lora = port_server({"prompt": prompt, "max_new_tokens": 6, "model_id": "lora:a"})
    assert lora["tokens"] != base["tokens"]
    assert "lora:a" in port_server.kv_stats()["adapters_resident"]


def test_registered_lora_loads_through_the_default_loader(port_params):
    llm.register_lora("lora:reg", llm.random_lora(CFG, rank=2, seed=9, scale=4.0))
    srv = llm.LLMServer(CFG, params=port_params, device="cpu", **SETTINGS)
    try:
        r = srv({"prompt": _prompt(7, 20), "max_new_tokens": 3, "model_id": "lora:reg"})
        assert len(r["tokens"]) == 3 and r["model_id"] == "lora:reg"
        with pytest.raises(KeyError):
            srv({"prompt": _prompt(7, 20), "max_new_tokens": 3, "model_id": "nope"})
        assert srv.kv_stats()["kv_blocks_in_use"] == srv.kv_stats()["prefix_cached_blocks"]
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# batching and the leak surface
# ---------------------------------------------------------------------------


def test_ttft_reported_and_concurrent_batching(port_server):
    out = []

    def call(i):
        out.append(port_server({"prompt": _prompt(50 + i, 20), "max_new_tokens": 8}))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(out) == 4
    for r in out:
        assert r["ttft_s"] is not None and 0 < r["ttft_s"] < 60
        assert len(r["tokens"]) == 8


def test_closed_server_frees_its_engine_and_pool_without_the_collector(port_params):
    """A served and closed LLMServer, with prefix caching and an adapter
    loader, frees its engine and KV pool by reference count: no reference
    cycle keeps them (and, at full size, GiBs of device memory) until the
    cyclic collector runs."""
    threads = set(threading.enumerate())
    srv = llm.LLMServer(CFG, params=port_params, device="cpu", prefix_caching=True,
                        adapter_loader=lambda mid: _ADAPTERS[mid], **SETTINGS)
    prompt = _prompt(12, 40)
    for model_id in (None, "lora:a", None):
        r = srv({"prompt": prompt, "max_new_tokens": 3, "model_id": model_id})
    assert r["prefix_cached_tokens"] > 0
    assert "lora:a" in srv.kv_stats()["adapters_resident"]
    engine, pool = weakref.ref(srv._engine), weakref.ref(srv._engine.pool)
    gc.disable()
    try:
        srv.close()
        for t in set(threading.enumerate()) - threads:  # the scheduler thread
            t.join(timeout=30)
        del srv, r
        assert engine() is None, "the closed server's engine is still referenced"
        assert pool() is None, "the closed server's KV pool is still referenced"
    finally:
        gc.enable()


def test_kv_exhaustion_sheds_without_leak(port_params):
    srv = llm.LLMServer(CFG, params=port_params, device="cpu", num_blocks=2,
                        block_size=16, prefix_caching=False, cache_buckets=(64,))
    try:
        with pytest.raises(BackPressureError) as ei:
            srv({"prompt": _prompt(7, 40), "max_new_tokens": 4})
        assert ei.value.retry_after_s > 0
        assert srv.kv_stats()["kv_blocks_in_use"] == 0
        r = srv({"prompt": _prompt(8, 20), "max_new_tokens": 4})
        assert len(r["tokens"]) == 4
        assert srv.kv_stats()["kv_blocks_in_use"] == 0
    finally:
        srv.close()


def test_stream_cancel_releases_kv_exactly_once(port_params):
    srv = llm.LLMServer(CFG, params=port_params, device="cpu",
                        step_delay_s=0.02, **SETTINGS)
    try:
        gen = srv.stream({"prompt": _prompt(9, 30), "max_new_tokens": 80})
        assert isinstance(next(gen), int)
        assert srv.kv_stats()["kv_blocks_in_use"] > 0
        gen.close()  # the client walks away mid-decode
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            s = srv.kv_stats()
            if s["kv_blocks_in_use"] == s["prefix_cached_blocks"]:
                break
            time.sleep(0.05)
        s = srv.kv_stats()
        assert s["kv_blocks_in_use"] == s["prefix_cached_blocks"]
    finally:
        srv.close()


def test_batcher_release_hook_fires_exactly_once_on_cancel():
    released, seen = [], {}

    def step(seqs):
        for s in seqs:
            if s.state is None:
                s.state = 0
                s.on_release = lambda s=s: released.append(s)
                seen[id(s)] = s

    b = batching._ContinuousBatcher(step, 4, 0.001, name="t")
    try:
        threading.Thread(target=lambda: b.submit("x"), daemon=True).start()
        deadline = time.monotonic() + 5
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        seq = next(iter(seen.values()))
        seq.cancelled = True
        with b.cv:
            b.cv.notify_all()
        deadline = time.monotonic() + 5
        while not released and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)  # more steps run: the hook must not fire again
        assert len(released) == 1 and seq._event.is_set()
    finally:
        b.shutdown(drain=False)


def test_batcher_poisoned_step_runs_release_hooks():
    released = []

    def step(seqs):
        for s in seqs:
            s.on_release = lambda: released.append(1)
        raise RuntimeError("forward crashed")

    b = batching._ContinuousBatcher(step, 4, 0.001, name="t")
    try:
        with pytest.raises(RuntimeError, match="forward crashed"):
            b.submit("x")
        assert released == [1]
    finally:
        b.shutdown(drain=False)


def test_bucket_pad_size_matches_the_reference():
    for n in (1, 3, 8, 9, 40, 100):
        assert batching.bucket_pad_size(n, (8, 16, 32)) == jbatching.bucket_pad_size(
            n, (8, 16, 32))
