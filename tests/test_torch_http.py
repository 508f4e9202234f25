"""The port's HTTP front end against the JAX package's.

``repro_torch.http`` is the JAX package's ``http/`` with its imports turned
to the port, so the wire format must be the same bytes: the protocol
functions on the same bodies and the same served requests, and the
Prometheus text of a registry bound to the same virtual-clock serve, are
compared exactly.  Then ``Gateway.serve_http`` over the simulated pool
(KNN router, ``device="cpu"``) answers ``/v1/models``, ``/healthz``, unary
and streamed completions and ``/metrics`` over loopback, and each unary
body equals the JAX ``HttpFrontend``'s for the same query (wall-clock
latency, the one timing field, left out) and the port's in-process
``Gateway.serve``.
"""
import json
import re
import urllib.request

import pytest
import torch

import repro.api as japi
import repro.http.protocol as jproto
from repro.http import MetricsRegistry as JaxMetricsRegistry
from repro.serving.online import OnlineConfig as JaxOnlineConfig
from repro_torch import api
from repro_torch.http import HttpFrontend, MetricsRegistry
from repro_torch.http import protocol as proto
from repro_torch.serving.online import OnlineConfig


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POOL = dict(task="agnews", n_train=192, n_val=48, n_test=96, seed=0)
WINDOW = 0.03
QS = (3, 11, 42, 7)


@pytest.fixture(scope="module")
def gateways():
    spec = dict(router="knn", coreset_size=48)
    jgw = japi.Gateway.from_spec(japi.RunSpec(pool=japi.PoolSpec(**POOL), **spec)).fit()
    gw = api.Gateway.from_spec(api.RunSpec(pool=api.PoolSpec(**POOL), **spec),
                               device="cpu").fit()
    return jgw, gw


def _arrivals(gw, n=12):
    test = gw.wl.subset_indices("test")
    return [(0.05 * i, int(test[(5 * i) % len(test)])) for i in range(n)]


@pytest.fixture(scope="module")
def served(gateways):
    """Both gateways after the same virtual-clock serve, each with a bound
    registry."""
    jgw, gw = gateways
    jreg, reg = JaxMetricsRegistry(), MetricsRegistry()
    jgw.serve(_arrivals(gw), JaxOnlineConfig(budget_per_s=1e6, window_s=0.25), metrics=jreg)
    gw.serve(_arrivals(gw), OnlineConfig(budget_per_s=1e6, window_s=0.25), metrics=reg)
    return jgw, gw, jreg, reg


BODIES = [
    {"messages": [{"role": "user", "content": "hi"}], "stream": True, "query_idx": 4},
    {"messages": [{"role": "system", "content": "s"}, {"role": "user", "content": "#7"}],
     "temperature": 0.7, "top_p": 0.9, "max_tokens": 12, "seed": 3},
    {"messages": [{"role": "user", "content": "q2"}], "model": "qwen3-4b"},
    "not json", [], {"messages": []}, {"messages": [{"role": "assistant", "content": "x"}]},
    {"messages": [{"role": "user", "content": "x"}], "query_idx": "seven"},
    {"messages": [{"role": "user", "content": "x"}], "logprobs": True},
    {"messages": [{"role": "user", "content": "x"}], "temperature": 9.0},
]


def _parse(mod, body):
    raw = body.encode() if isinstance(body, str) else json.dumps(body).encode()
    try:
        out = mod.parse_chat_body(raw)
    except mod.ApiError as e:
        return ("error", e.status, str(e))
    gen = out.get("gen")
    return {**out, "gen": gen.to_dict() if gen is not None else None}


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_parse_chat_body_matches(i):
    assert _parse(proto, BODIES[i]) == _parse(jproto, BODIES[i])


def test_resolve_query_idx_matches():
    universe = [100, 101, 102, 103]
    text_index = {"what is 2+2": 102}
    for content, qi in (("anything", 2), ("what is 2+2", None), ("#1", None), ("q3", None),
                        ("free-form question", None), ("x", 99)):
        got = []
        for mod in (proto, jproto):
            try:
                got.append(mod.resolve_query_idx({"content": content, "query_idx": qi},
                                                 universe, text_index))
            except mod.ApiError as e:
                got.append(("error", e.status, str(e)))
        assert got[0] == got[1], content


def test_responses_and_frames_match(served):
    jgw, gw, _, _ = served
    jdone = sorted(jgw.server.completed, key=lambda r: r.rid)
    done = sorted(gw.server.completed, key=lambda r: r.rid)
    assert len(done) == len(jdone) == 12
    for jr, r in zip(jdone, done):
        jname = None if jr.model is None else jgw.pool[jr.model].name
        name = None if r.model is None else gw.pool[r.model].name
        assert name == jname
        assert proto.completion_response(r, name, gw.wl) == jproto.completion_response(
            jr, jname, jgw.wl)
        assert proto.role_frame(r, name) == jproto.role_frame(jr, jname)
        assert proto.chunk_frame(r, "4;7", name) == jproto.chunk_frame(jr, "4;7", jname)
        assert proto.finish_frame(r, name, gw.wl) == jproto.finish_frame(jr, jname, jgw.wl)
    assert proto.models_response(gw.pool) == jproto.models_response(jgw.pool)
    assert proto.SSE_DONE == jproto.SSE_DONE


def test_metrics_text_matches(served):
    _, _, jreg, reg = served
    text = reg.render()
    assert text == jreg.render()
    m = re.search(r'robatch_requests_total\{outcome="(?:served|cache_hit)"\} (\d+)', text)
    assert m and "robatch_windows_total" in text


def _post(base, payload, timeout=30.0):
    req = urllib.request.Request(base + "/v1/chat/completions",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _sse_content(resp):
    frames = []
    for line in resp:
        line = line.strip()
        if line.startswith(b"data: "):
            payload = line[len(b"data: "):]
            frames.append("DONE" if payload == b"[DONE]" else json.loads(payload))
    assert frames[-1] == "DONE"
    return "".join(c["choices"][0]["delta"].get("content", "") for c in frames[:-1])


def _unary_bodies(fe, qs):
    base = f"http://127.0.0.1:{fe.port}"
    out = []
    for q in qs:                    # sequential: each request rides its own window
        with _post(base, {"messages": [{"role": "user", "content": "x"}],
                          "query_idx": q}) as r:
            body = json.loads(r.read())
        assert body["robatch"].pop("latency_s") >= 0.0
        out.append(body)
    return out


def test_serve_http_answers_as_jax_and_in_process(gateways):
    jgw, gw = gateways
    jfe = jgw.serve_http(JaxOnlineConfig(budget_per_s=1e6, window_s=WINDOW, realtime=True))
    try:
        want = _unary_bodies(jfe, QS)
    finally:
        jfe.stop()
    fe = gw.serve_http(OnlineConfig(budget_per_s=1e6, window_s=WINDOW, realtime=True))
    assert isinstance(fe, HttpFrontend)
    try:
        base = f"http://127.0.0.1:{fe.port}"
        with urllib.request.urlopen(base + "/v1/models", timeout=10) as r:
            models = json.loads(r.read())
        assert [m["id"] for m in models["data"]] == [m.name for m in gw.pool]
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200 and json.loads(r.read())
        got = _unary_bodies(fe, QS)
        with _post(base, {"messages": [{"role": "user", "content": "x"}],
                          "query_idx": QS[0], "stream": True}) as r:
            streamed = _sse_content(r)
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            metrics = r.read().decode()
    finally:
        fe.stop()
    assert not fe.threads_leaked
    assert got == want
    assert streamed == got[0]["choices"][0]["message"]["content"]
    assert re.search(r'robatch_http_requests_total\{[^}]*\} \d+', metrics)
    # the in-process path gives the same bodies for the same queries
    test_idx = gw.wl.subset_indices("test")
    gw.serve([(i * WINDOW * 2, int(test_idx[q])) for i, q in enumerate(QS)],
             OnlineConfig(budget_per_s=1e6, window_s=WINDOW))
    by_rid = {r.rid: r for r in gw.server.completed}
    for rid, body in enumerate(got):
        req = by_rid[rid]
        inproc = proto.completion_response(req, gw.pool[req.model].name, gw.wl)
        inproc["robatch"].pop("latency_s")
        assert body == inproc
