"""The port's LLMServer inside ray_tpu's serve plane, on the CPU: gpt_nano
weights from the reference's ``make_params(seed=0)`` carried across by
``models/convert.py``, the server deployed with ray_tpu's hooks
(scripts/port_runtime_smoke.py's ``runtime_hooks``) behind
``serve.deployment`` and the HTTP proxy.

* Over HTTP it gives the in-process JAX LLMServer's tokens for the same
  prompts, and a LoRA adapter published with ``serve.register_model`` gives
  the JAX server's tokens under the same adapter.
* A client that hangs up mid-decode releases its KV blocks (the counterpart
  of tests/test_llm.py's ``test_client_eof_releases_kv_blocks``).
* A request shed for want of KV blocks is answered 503 with Retry-After
  (the port's own error class, which the proxy does not know, gave 500).
* For the same requests, in process, the port's engine reports the JAX
  engine's metric names and values (``ray_tpu_llm_prefill_tokens_total``,
  ``..._prefix_cache_hits_total`` and ``..._kv_blocks_in_use`` equal, one
  ``..._ttft_seconds`` observation per request); the deployed replica's
  reach the runtime's metrics.

Every ``result``, ``get`` and HTTP call has its own time limit.
"""

import http.client
import json
import socket
import time

import jax
import numpy as np
import pytest

import ray_tpu
from ray_tpu import serve
from ray_tpu._private import internal_metrics
from ray_tpu.serve import batching as jbatching
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import convert, gpt
from ray_tpu_torch.serve import llm
from scripts.port_runtime_smoke import runtime_hooks

CFG = gpt.gpt_nano()
SETTINGS = dict(num_blocks=64, block_size=16, prefill_lanes=2, lane_buckets=(1, 2, 4),
                prefill_token_buckets=(16, 32), cache_buckets=(64, 128))
ADAPTER = llm.random_lora(CFG, rank=4, seed=3, scale=4.0)
METRICS = ("ray_tpu_llm_prefill_tokens_total", "ray_tpu_llm_prefix_cache_hits_total",
           "ray_tpu_llm_kv_blocks_in_use", "ray_tpu_llm_ttft_seconds")


def _prompt(seed: int, n: int):
    return [int(t) for t in np.random.RandomState(seed).randint(0, CFG.vocab_size, n)]


#: a shared 32-token prefix (two full blocks) so the prefix cache hits
_SHARED = _prompt(40, 32)
PAYLOADS = [{"prompt": _SHARED + _prompt(41, 5), "max_new_tokens": 6},
            {"prompt": _SHARED + _prompt(42, 9), "max_new_tokens": 6},
            {"prompt": _prompt(43, 20), "max_new_tokens": 8},
            {"prompt": _prompt(44, 12), "max_new_tokens": 5, "model_id": "lora:a"}]


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jllm.make_params(seed=0))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return convert.params_from_jax(jax_params, CFG, device="cpu")


@pytest.fixture(scope="module")
def jax_tokens(jax_params):
    srv = jllm.LLMServer(None, params=jax_params, prefix_caching=True,
                         adapter_loader=lambda mid: (ADAPTER["A"], ADAPTER["B"],
                                                     ADAPTER["scale"]), **SETTINGS)
    try:
        return [srv(p)["tokens"] for p in PAYLOADS]
    finally:
        jbatching.shutdown_batchers(srv)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu.init(num_cpus=4, log_level="WARNING",
                 _system_config={"metrics_report_period_s": 0.5})
    try:
        yield
    finally:
        serve.shutdown()
        ray_tpu.shutdown()
        from ray_tpu._private.config import GlobalConfig

        GlobalConfig.initialize({"metrics_report_period_s": 5.0})


def _deploy(name: str, params, **engine):
    dep = serve.deployment(llm.LLMServer, name=name, max_concurrent_queries=8).bind(
        CFG, params, "cpu", hooks=runtime_hooks(), deployment=name, **{**SETTINGS, **engine})
    return serve.run(dep)


def _post(proxy, route: str, payload: dict, timeout: float = 60.0):
    conn = http.client.HTTPConnection(proxy.host, proxy.port, timeout=timeout)
    try:
        conn.request("POST", f"/{route}", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _await(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_deployed_port_server_over_http(cluster, port_params, jax_tokens):
    """Tokens over HTTP equal the JAX server's (the adapter published with
    serve.register_model included); the replica's metrics reach the
    runtime's."""
    from ray_tpu.util import metrics as rt_metrics

    h = _deploy("portllm", port_params)
    serve.register_model("lora:a", ADAPTER)
    proxy = serve.start_http_proxy()
    try:
        got = []
        for p in PAYLOADS:
            status, _, body = _post(proxy, "portllm", p)
            assert status == 200, body
            got.append(json.loads(body)["result"]["tokens"])
        assert got == jax_tokens
        stats = h.kv_stats.remote().result(timeout=30)
        # only the prefix cache holds blocks once the requests are done
        assert stats["kv_blocks_in_use"] == stats["prefix_cached_blocks"] > 0
        assert stats["adapters_resident"] == ["lora:a"]

        def reported():
            recs = rt_metrics.get_metrics("ray_tpu_llm_prefill_tokens_total")
            return any(dict(k).get("deployment") == "portllm" and v == stats["prefill_tokens"]
                       for r in recs for k, v in _series(r).items())

        _await(reported, 30, "the replica's prefill tokens in the runtime's metrics")
    finally:
        proxy.stop()


def _series(record):
    series = record.get("series", {})
    return series if isinstance(series, dict) else {tuple(map(tuple, k)): v
                                                      for k, v in series}


def test_client_eof_releases_kv_blocks(cluster, port_params):
    # tests/test_llm.py's settings: no prefix cache, so an idle pool is empty;
    # each step stretched so the decode outlives the polls
    h = _deploy("portcancel", port_params, prefix_caching=False, step_delay_s=0.05)
    proxy = serve.start_http_proxy()
    try:
        warm = h.remote({"prompt": _prompt(10, 30), "max_new_tokens": 2}).result(timeout=120)
        assert len(warm["tokens"]) == 2
        assert h.kv_stats.remote().result(timeout=30)["kv_blocks_in_use"] == 0
        payload = json.dumps({"prompt": _prompt(11, 30), "max_new_tokens": 90}).encode()
        request = (f"POST /portcancel HTTP/1.1\r\nHost: {proxy.host}\r\n"
                   f"Content-Type: application/json\r\n"
                   f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload
        conn = socket.create_connection((proxy.host, proxy.port), timeout=30)
        conn.sendall(request)
        _await(lambda: h.kv_stats.remote().result(timeout=30)["kv_blocks_in_use"] > 0,
               30, "decode in flight")
        conn.close()  # client EOF mid-decode
        _await(lambda: h.kv_stats.remote().result(timeout=30)["kv_blocks_in_use"] == 0,
               30, "KV blocks released after client EOF")
    finally:
        proxy.stop()


def test_shed_request_is_503_with_retry_after(cluster, port_params):
    """Four blocks of 16 cannot hold a 100-token prompt: the engine sheds it
    with the runtime's BackPressureError, which the proxy answers 503."""
    h = _deploy("portshed", port_params, num_blocks=4)
    proxy = serve.start_http_proxy()
    try:
        status, headers, body = _post(proxy, "portshed",
                                      {"prompt": _prompt(12, 100), "max_new_tokens": 2})
        assert status == 503, (status, body)
        assert int(headers["Retry-After"]) >= 1
        assert h.kv_stats.remote().result(timeout=30)["kv_blocks_in_use"] == 0
    finally:
        proxy.stop()


def _snapshot(name: str, deployment: str):
    series = internal_metrics.get(name)._snapshot()["series"]
    return next((v for k, v in series.items() if dict(k) == {"deployment": deployment}), None)


def test_port_engine_reports_the_jax_engines_metrics(jax_params, port_params):
    """The same requests through both engines in process, each reporting to
    ray_tpu's metrics under its own deployment tag."""
    adapter = lambda mid: (ADAPTER["A"], ADAPTER["B"], ADAPTER["scale"])  # noqa: E731
    jsrv = jllm.LLMServer(None, params=jax_params, prefix_caching=True,
                          adapter_loader=adapter, deployment="jax-metrics", **SETTINGS)
    psrv = llm.LLMServer(CFG, port_params, "cpu", hooks=runtime_hooks(),
                         deployment="port-metrics", adapter_loader=adapter, **SETTINGS)
    try:
        for p in PAYLOADS:
            assert psrv(p)["tokens"] == jsrv(p)["tokens"]
        stats = psrv.kv_stats()
    finally:
        jbatching.shutdown_batchers(jsrv)
        psrv.close()
    for name in METRICS[:3]:
        want, got = _snapshot(name, "jax-metrics"), _snapshot(name, "port-metrics")
        assert want is not None and got == want, (name, got, want)
    assert _snapshot("ray_tpu_llm_prefill_tokens_total", "port-metrics") == stats[
        "prefill_tokens"]
    assert _snapshot("ray_tpu_llm_prefix_cache_hits_total", "port-metrics") == stats[
        "prefix_hits"] > 0
    assert _snapshot("ray_tpu_llm_kv_blocks_in_use", "port-metrics") == stats[
        "kv_blocks_in_use"] > 0  # the prefix cache holds its blocks
    want = _snapshot("ray_tpu_llm_ttft_seconds", "jax-metrics")
    got = _snapshot("ray_tpu_llm_ttft_seconds", "port-metrics")
    assert got["count"] == want["count"] == len(PAYLOADS)
