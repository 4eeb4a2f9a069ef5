"""Persistent JSONL serving: `Pipeline.serve` + the `bsr serve` loop.

The reference's only serving story is re-running the binary with
SKIP_PROCESS=true for one hardcoded query index (src/main.rs:42-45,110-121);
the accept-loop here is beyond-parity capability, so these tests pin its
contract: one in-order response per request, errors never kill the stream,
and retrieval semantics identical to Pipeline.query.
"""

import io
import json

import numpy as np
import pytest

from better_search_rag_rust_tpu.cli import serve_loop
from better_search_rag_rust_tpu.config import (
    CorpusConfig,
    EncoderConfig,
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)
from better_search_rag_rust_tpu.pipeline import Pipeline


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A built store + a serving Pipeline over it (hash encoder, 12 files)."""
    tmp_path = tmp_path_factory.mktemp("serve")
    root = tmp_path / "repo"
    root.mkdir()
    for i in range(12):
        (root / f"File{i}.java").write_text(
            f"public class File{i} {{ void method{i}() {{}} }}"
        )
    cfg = PipelineConfig(
        corpus=CorpusConfig(root=str(root), extensions=("java",),
                            files_per_batch=4),
        encoder=EncoderConfig(backend="hash", dim=96, vocab_size=4096,
                              max_tokens=64, batch_size=4),
        store=StoreConfig(dir=str(tmp_path / "vstore")),
        search=SearchConfig(top_k=5, chunk_rows=256),
    )
    build = Pipeline(cfg)
    build.ingest_shard()
    build.merge()
    serve_cfg = PipelineConfig(
        corpus=cfg.corpus, encoder=cfg.encoder, store=cfg.store,
        search=cfg.search, skip_process=True,
    )
    return Pipeline(serve_cfg)


def test_serve_matches_query(served):
    """A served text request returns exactly Pipeline.query's ranking."""
    text = "public class File3 void method3"
    resp = next(iter(served.serve([{"id": 7, "query": text}])))
    assert resp["id"] == 7
    expected = served.query([text])[0]
    got = [(r["path"], r["row"], r["distance"]) for r in resp["results"][0]]
    assert [(p, i) for p, i, _ in expected] == [(p, i) for p, i, _ in got]
    np.testing.assert_allclose(
        [d for _, _, d in expected], [d for _, _, d in got], rtol=1e-6
    )


def test_serve_batch_vectors_and_k_trim(served):
    """queries/vector/vectors request kinds; per-request k trims serve-k."""
    store_rows = served.engine().store.effective_matrix()[[0, 4]]
    reqs = [
        {"id": "batch", "queries": ["method one", "method two"], "k": 2},
        {"id": "vec", "vector": store_rows[0].tolist(), "k": 1},
        {"id": "vecs", "vectors": store_rows.tolist(), "k": 3},
    ]
    out = list(served.serve(iter(reqs)))
    assert [r["id"] for r in out] == ["batch", "vec", "vecs"]
    assert [len(q) for q in out[0]["results"]] == [2, 2]
    # a stored row retrieves itself at rank 1 with ~zero distance
    assert out[1]["results"][0][0]["row"] == 0
    assert out[1]["results"][0][0]["distance"] < 1e-3
    assert [q[0]["row"] for q in out[2]["results"]] == [0, 4]
    assert all(len(q) == 3 for q in out[2]["results"])


def test_serve_text_device_path_matches_host(served, monkeypatch):
    """Text requests ride the device-resident embedding fast path (no
    readback, no re-upload); responses are identical to the host fallback
    — an f32 round trip is lossless. The 3-query batch also covers the
    on-device row padding (padded to the next fixed shape)."""
    from better_search_rag_rust_tpu.models.encoder import EncoderService

    reqs = [{"id": 1, "queries": ["alpha beta", "gamma", "delta eps"]}]
    # Sanity: the hash encoder really does provide the device path.
    assert served.encoder.get_embeddings_device(["alpha beta"]) is not None
    dev_out = list(served.serve(iter(reqs)))
    monkeypatch.setattr(
        EncoderService, "get_embeddings_device", lambda self, texts: None
    )
    host_out = list(served.serve(iter(reqs)))
    assert dev_out == host_out


def test_get_embeddings_device_matches_host(served):
    """The device-resident embeddings are bitwise the host API's."""
    texts = ["one two three", "four five"]
    dev = served.encoder.get_embeddings_device(texts)
    host = served.encoder.get_embeddings(texts)
    np.testing.assert_array_equal(np.asarray(dev), host)


def test_search_async_device_queries(served):
    """engine.search_async accepts a device array and returns the same
    results as the host-queries path."""
    import jax.numpy as jnp

    engine = served.engine()
    q = served.encoder.get_embeddings(["lorem ipsum", "dolor sit"])
    want = engine.search(q, k=4)
    got = engine.collect(engine.search_async(jnp.asarray(q), k=4))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_serve_errors_in_order_never_kill_stream(served):
    """Bad requests produce in-order error responses; serving continues."""
    reqs = [
        {"id": 0, "query": "fine"},
        {"id": 1},  # no query kind at all
        {"id": 2, "query": "x", "vector": [1.0]},  # two kinds
        {"id": 3, "k": 99, "query": "x"},  # k beyond serve top_k
        {"id": 4, "k": 0, "query": "x"},  # non-positive k
        {"id": 5, "vector": [[1.0], [2.0]], "vectors": None, "queries": None},
        {"id": 6, "queries": ["ok again"]},
        "not even an object",
        {"id": 8, "vectors": [[1.0, 2.0]]},  # wrong dim
        {"id": 9, "query": "last one fine"},
    ]
    out = list(served.serve(iter(reqs), depth=2))
    assert len(out) == len(reqs)
    assert [r.get("id") for r in out] == [0, 1, 2, 3, 4, 5, 6, None, 8, 9]
    ok = {0, 6, 9}
    for i, resp in enumerate(out):
        if i in ok:
            assert "results" in resp, resp
        else:
            assert "error" in resp, resp
    assert "exceeds the serve-wide top_k" in out[3]["error"]
    assert "query dim" in out[8]["error"]


def test_serve_depths_agree(served):
    """Pipelining depth changes scheduling, never results."""
    reqs = [{"id": i, "query": f"method {i}"} for i in range(6)]
    base = list(served.serve(iter(reqs), depth=1))
    deep = list(served.serve(iter(reqs), depth=3))
    assert base == deep


def test_serve_loop_jsonl_round_trip(served):
    """The CLI loop: JSONL in -> JSONL out, malformed lines answered."""
    lines = "\n".join(
        [
            json.dumps({"id": 1, "query": "public class File0"}),
            "",  # blank line skipped
            "{this is not json",
            json.dumps({"id": 3, "queries": ["a method", "another"], "k": 1}),
        ]
    )
    out = io.StringIO()
    rc = serve_loop(served, io.StringIO(lines), out, k=5, depth=2)
    assert rc == 0
    responses = [json.loads(l) for l in out.getvalue().splitlines()]
    assert len(responses) == 3
    assert responses[0]["id"] == 1 and "results" in responses[0]
    assert "malformed JSON" in responses[1]["error"]
    assert responses[2]["id"] == 3
    assert [len(q) for q in responses[2]["results"]] == [1, 1]


def test_serve_cli_wiring():
    """`bsr serve --help` parses (subcommand registered with flags)."""
    from better_search_rag_rust_tpu.cli import main

    with pytest.raises(SystemExit) as exc:
        main(["serve", "--help"])
    assert exc.value.code == 0


def test_serve_tcp_round_trip(served):
    """JSONL over TCP: two concurrent connections, in-order responses each."""
    import socket
    import threading

    from better_search_rag_rust_tpu.cli import make_tcp_server

    server = make_tcp_server(served, "127.0.0.1", 0, k=5, depth=2)
    host, port = server.server_address
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        def client(reqs):
            with socket.create_connection((host, port), timeout=30) as s:
                f = s.makefile("rw", encoding="utf-8")
                for r in reqs:
                    f.write(json.dumps(r) + "\n")
                f.flush()
                s.shutdown(socket.SHUT_WR)
                return [json.loads(l) for l in f]

        reqs_a = [{"id": i, "query": f"method {i}"} for i in range(3)]
        reqs_b = [{"id": "bad"}, {"id": "ok", "queries": ["File1"], "k": 1}]
        out_a, out_b = [None], [None]
        ta = threading.Thread(target=lambda: out_a.__setitem__(0, client(reqs_a)))
        tb = threading.Thread(target=lambda: out_b.__setitem__(0, client(reqs_b)))
        ta.start(); tb.start(); ta.join(60); tb.join(60)
        assert [r["id"] for r in out_a[0]] == [0, 1, 2]
        assert all("results" in r for r in out_a[0])
        assert "error" in out_b[0][0] and "results" in out_b[0][1]
        # TCP responses match the in-process serve path exactly
        direct = list(served.serve(iter(reqs_a)))
        assert out_a[0] == direct
    finally:
        server.shutdown()
        server.server_close()


def test_serve_sync_ping_pong_tcp(served):
    """THE deadlock regression: a synchronous client sends ONE request and
    waits for the answer before sending the next. Before the flush-token
    protocol the server sat in readline() while the result waited in the
    pending queue, at every depth."""
    import socket
    import threading

    from better_search_rag_rust_tpu.cli import make_tcp_server

    server = make_tcp_server(served, "127.0.0.1", 0, k=5, depth=2)
    host, port = server.server_address
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with socket.create_connection((host, port), timeout=30) as s:
            f = s.makefile("rw", encoding="utf-8")
            f.write(json.dumps({"id": 1, "query": "method one"}) + "\n")
            f.flush()
            r1 = json.loads(f.readline())  # no further traffic sent
            assert r1["id"] == 1 and "results" in r1
            f.write(json.dumps({"id": 2}) + "\n")  # bad request
            f.flush()
            r2 = json.loads(f.readline())  # error answered immediately too
            assert r2["id"] == 2 and "error" in r2
            f.write(json.dumps({"id": 3, "queries": ["more"], "k": 1}) + "\n")
            f.flush()
            r3 = json.loads(f.readline())
            assert r3["id"] == 3 and len(r3["results"][0]) == 1
    finally:
        server.shutdown()
        server.server_close()


def test_serve_tcp_binary_garbage_answered(served):
    """Undecodable bytes produce a malformed-JSON error response for that
    line; the connection (and later requests) keep working."""
    import socket
    import threading

    from better_search_rag_rust_tpu.cli import make_tcp_server

    server = make_tcp_server(served, "127.0.0.1", 0, k=5, depth=1)
    host, port = server.server_address
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with socket.create_connection((host, port), timeout=30) as s:
            s.sendall(b"\xff\xfe{binary\n")
            s.sendall(
                json.dumps({"id": 2, "query": "still alive"}).encode() + b"\n"
            )
            f = s.makefile("r", encoding="utf-8")
            r1 = json.loads(f.readline())
            assert "error" in r1 and "malformed JSON" in r1["error"]
            r2 = json.loads(f.readline())
            assert r2["id"] == 2 and "results" in r2
    finally:
        server.shutdown()
        server.server_close()


def test_serve_flush_token_and_bool_k(served):
    """None items flush in-flight responses in place (and no-op when idle);
    JSON true/false never sneak through the integer k check."""
    reqs = [None, {"id": 0, "query": "a"}, None,
            {"id": 1, "query": "b", "k": True}, None,
            {"id": 2, "query": "c"}]
    out = list(served.serve(iter(reqs), depth=3))
    assert [r["id"] for r in out] == [0, 1, 2]
    assert "results" in out[0] and "results" in out[2]
    assert "k must be a positive integer" in out[1]["error"]


def test_serve_underscore_key_is_an_ordinary_request(served):
    """A well-formed request that happens to contain a \"_malformed\" key is
    served normally (the malformed marker is an out-of-band wrapper type)."""
    resp = next(iter(served.serve([
        {"id": 5, "query": "method", "_malformed": "not special"}
    ])))
    assert resp["id"] == 5 and "results" in resp


def test_serve_pads_batches_to_fixed_shapes(served):
    """Client batch sizes bucket to powers of two before dispatch: a
    long-lived server must not compile one program per distinct size."""
    from better_search_rag_rust_tpu.pipeline import _serve_batch_shape

    assert [_serve_batch_shape(n) for n in (1, 2, 3, 5, 9, 1024)] == \
        [1, 2, 4, 8, 16, 1024]
    assert _serve_batch_shape(1025) == 2048  # above 1024: multiples of 1024
    engine = served.engine()
    mat = engine.store.effective_matrix()
    for n in (3, 5):
        reqs = [{"id": n, "vectors": mat[:n].tolist()}]
        (resp,) = list(served.serve(iter(reqs)))
        assert len(resp["results"]) == n  # padding trimmed from the response
        assert [q[0]["row"] for q in resp["results"]] == list(range(n))
    compiled_q = {key[0] for key in engine._compiled}
    assert 3 not in compiled_q and 5 not in compiled_q
    assert {4, 8} <= compiled_q


def test_serve_with_batcher_matches_unbatched(served):
    """Batched serving is a pure routing change: responses (ids, paths,
    order, error handling) are identical to the unbatched path; distances
    agree to CPU-backend batch-shape ulp."""
    from better_search_rag_rust_tpu.batcher import DynamicBatcher

    store_rows = served.engine().store.effective_matrix()[[0, 4]]
    reqs = [
        {"id": 1, "query": "public class File2 method2"},
        {"id": 2, "queries": ["a method", "another"], "k": 2},
        {"id": "bad"},  # no query kind -> in-order error response
        {"id": 3, "vectors": store_rows.tolist(), "k": 1},
    ]
    direct = list(served.serve(iter(reqs)))
    with DynamicBatcher(served.engine(), k=5, window_ms=5.0) as b:
        batched = list(served.serve(iter(reqs), batcher=b))
    assert [r["id"] for r in batched] == [r["id"] for r in direct]
    assert "error" in batched[2] and "error" in direct[2]
    for db, dd in zip(batched, direct):
        if "results" not in dd:
            continue
        got = [[(e["path"], e["row"]) for e in q] for q in db["results"]]
        want = [[(e["path"], e["row"]) for e in q] for q in dd["results"]]
        assert got == want
    assert b.stats.requests == 3  # the bad request never reached the batcher


def test_serve_batcher_coalesces_across_connections(served):
    """Two TCP clients' single-query requests landing within one window share
    a device dispatch (the many-clients regime the batcher exists for)."""
    import socket
    import threading

    from better_search_rag_rust_tpu.batcher import DynamicBatcher
    from better_search_rag_rust_tpu.cli import make_tcp_server

    engine = served.engine()
    with DynamicBatcher(engine, k=5, window_ms=250.0) as b:
        server = make_tcp_server(served, "127.0.0.1", 0, k=5, depth=1,
                                 batcher=b)
        host, port = server.server_address
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            barrier = threading.Barrier(4)
            outs = {}

            def client(i):
                barrier.wait()
                with socket.create_connection((host, port), timeout=60) as s:
                    f = s.makefile("rw", encoding="utf-8")
                    f.write(json.dumps({"id": i, "query": f"method {i}"}) + "\n")
                    f.flush()
                    outs[i] = json.loads(f.readline())

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(90)
            assert sorted(outs) == [0, 1, 2, 3]
            for i, resp in outs.items():
                assert resp["id"] == i and "results" in resp
                direct = next(iter(served.serve(
                    [{"id": i, "query": f"method {i}"}]
                )))
                got = [(e["path"], e["row"]) for e in resp["results"][0]]
                want = [(e["path"], e["row"]) for e in direct["results"][0]]
                assert got == want
        finally:
            server.shutdown()
            server.server_close()
    assert b.stats.requests == 4
    assert b.stats.batches < 4, b.stats  # coalescing actually happened


def test_serve_batcher_k_too_small_raises(served):
    from better_search_rag_rust_tpu.batcher import DynamicBatcher

    with DynamicBatcher(served.engine(), k=3, window_ms=1.0) as b:
        with pytest.raises(ValueError, match="batcher was built for k=3"):
            next(iter(served.serve([{"query": "x"}], k=5, batcher=b)))


def test_serve_hot_reload_after_update(tmp_path):
    """{"cmd": "reload"}: a live serve loop picks up an incremental
    update() (edit + add) without restarting — the edited file answers with
    its new content and the new file becomes retrievable; in-flight
    requests drain first and ordering is preserved."""
    root = tmp_path / "repo"
    root.mkdir()
    for i in range(8):
        (root / f"File{i}.java").write_text(
            f"public class File{i} {{ void method{i}() {{}} }}"
        )
    cfg = PipelineConfig(
        corpus=CorpusConfig(root=str(root), extensions=("java",),
                            files_per_batch=4),
        encoder=EncoderConfig(backend="hash", dim=96, vocab_size=4096,
                              max_tokens=64, batch_size=4),
        store=StoreConfig(dir=str(tmp_path / "vstore")),
        search=SearchConfig(top_k=5, chunk_rows=256),
    )
    build = Pipeline(cfg)
    build.ingest_shard()
    build.merge()

    server = Pipeline(cfg.replace(skip_process=True))

    def requests():
        yield {"id": 1, "query": "public class File2 void method2"}
        # mutate the corpus + store from "another process"
        (root / "File5.java").write_text(
            "public class File5 { String xenolith; }"
        )
        (root / "Fresh.java").write_text("class Fresh { int meteorite; }")
        stats = Pipeline(cfg.replace(skip_process=True)).update()
        assert stats.rows_reembedded == 1 and stats.embeddings == 1
        yield {"id": 2, "cmd": "reload"}
        yield {"id": 3, "query": "class File5 String xenolith"}
        yield {"id": 4, "query": "class Fresh int meteorite"}

    resps = list(server.serve(requests()))
    assert [r["id"] for r in resps] == [1, 2, 3, 4]
    assert resps[0]["results"][0][0]["path"].endswith("File2.java")
    assert resps[1]["reloaded"] is True and resps[1]["rows"] == 9
    assert resps[2]["results"][0][0]["path"].endswith("File5.java")
    assert resps[3]["results"][0][0]["path"].endswith("Fresh.java")


def test_serve_reload_hot_swaps_batcher(served):
    """reload through a shared micro-batcher hot-swaps the batcher's
    engine in place: the response confirms the reload, the generation
    bumps, and subsequent (and interleaved) queries keep answering with
    correct paths."""
    from better_search_rag_rust_tpu.batcher import DynamicBatcher

    engine = served.engine()
    with DynamicBatcher(engine, k=5, max_batch=8, window_ms=1.0) as b:
        gen0 = b.generation
        resps = list(served.serve(
            [
                {"id": 1, "query": "public class File2 void method2"},
                {"id": 2, "cmd": "reload"},
                {"id": 3, "query": "public class File3 void method3"},
            ],
            batcher=b,
        ))
        assert b.generation == gen0 + 1
        assert b.manifest_by_gen[b.generation] is not None
    assert [r["id"] for r in resps] == [1, 2, 3]
    assert resps[0]["results"][0][0]["path"].endswith("File2.java")
    assert resps[1]["reloaded"] is True
    assert resps[2]["results"][0][0]["path"].endswith("File3.java")


def test_serve_reload_midupdate_answers_error_then_heals(tmp_path):
    """A reload landing while an update() is mid-rewrite can observe a NEW
    parquet with an OLD manifest (ADVICE r3): the server must answer a
    retryable error — never serve the misaligned pair — and heal on the
    next reload once the update has committed."""
    import json

    from better_search_rag_rust_tpu.store.vectorstore import (
        load_manifest,
        manifest_path,
        write_update_commit,
    )

    root = tmp_path / "repo"
    root.mkdir()
    for i in range(6):
        (root / f"File{i}.java").write_text(
            f"public class File{i} {{ void method{i}() {{}} }}"
        )
    cfg = PipelineConfig(
        corpus=CorpusConfig(root=str(root), extensions=("java",),
                            files_per_batch=4),
        encoder=EncoderConfig(backend="hash", dim=96, vocab_size=4096,
                              max_tokens=64, batch_size=4),
        store=StoreConfig(dir=str(tmp_path / "vstore")),
        search=SearchConfig(top_k=5, chunk_rows=256),
    )
    build = Pipeline(cfg)
    build.ingest_shard()
    build.merge()
    server = Pipeline(cfg.replace(skip_process=True))

    good_manifest = None

    def requests():
        nonlocal good_manifest
        yield {"id": 1, "query": "public class File2 void method2"}
        # Mid-update snapshot: manifest shorter than the store (one rename
        # landed, the next has not) — marker deliberately rewritten so ONLY
        # the row-count cross-check can catch it.
        good_manifest = load_manifest(cfg.store.dir)
        manifest_path(cfg.store.dir).write_text(
            json.dumps(good_manifest[:-1])
        )
        write_update_commit(cfg.store.dir)
        yield {"id": 2, "cmd": "reload"}
        # queries during the broken window answer retryable errors too
        yield {"id": 3, "query": "public class File3 void method3"}
        # the "update" commits (manifest restored + re-baselined)
        manifest_path(cfg.store.dir).write_text(json.dumps(good_manifest))
        write_update_commit(cfg.store.dir)
        yield {"id": 4, "cmd": "reload"}
        yield {"id": 5, "query": "public class File3 void method3"}

    resps = list(server.serve(requests()))
    assert [r["id"] for r in resps] == [1, 2, 3, 4, 5]
    assert resps[0]["results"][0][0]["path"].endswith("File2.java")
    assert "does not match" in resps[1]["error"]
    assert "retry" in resps[2]["error"]
    assert resps[3]["reloaded"] is True and resps[3]["rows"] == 6
    assert resps[4]["results"][0][0]["path"].endswith("File3.java")


def test_serve_batcher_reload_after_update_two_connections(tmp_path):
    """Shared-batcher hot reload end to end: corpus edits + update() land
    in another Pipeline, ONE connection sends reload, and BOTH connections
    (sharing the batcher) then retrieve the new/edited files with correct
    paths — including a deletion shifting row ids under the manifest."""
    from better_search_rag_rust_tpu.batcher import DynamicBatcher

    root = tmp_path / "repo"
    root.mkdir()
    for i in range(8):
        (root / f"File{i}.java").write_text(
            f"public class File{i} {{ void method{i}() {{}} }}"
        )
    cfg = PipelineConfig(
        corpus=CorpusConfig(root=str(root), extensions=("java",),
                            files_per_batch=4),
        encoder=EncoderConfig(backend="hash", dim=96, vocab_size=4096,
                              max_tokens=64, batch_size=4),
        store=StoreConfig(dir=str(tmp_path / "vstore")),
        search=SearchConfig(top_k=5, chunk_rows=256),
    )
    build = Pipeline(cfg)
    build.ingest_shard()
    build.merge()

    server = Pipeline(cfg.replace(skip_process=True))
    with DynamicBatcher(server.engine(), k=5, max_batch=8,
                        window_ms=1.0) as b:

        def conn_a():
            yield {"id": "a1", "query": "public class File2 void method2"}
            # another process mutates corpus + store: delete one file
            # (rows shift!), add one
            (root / "File0.java").unlink()
            (root / "Fresh.java").write_text("class Fresh { int meteorite; }")
            stats = Pipeline(cfg.replace(skip_process=True)).update()
            assert stats.rows_deleted == 1 and stats.embeddings == 1
            yield {"id": "a2", "cmd": "reload"}
            yield {"id": "a3", "query": "class Fresh int meteorite"}

        ra = list(server.serve(conn_a(), batcher=b))
        assert [r["id"] for r in ra] == ["a1", "a2", "a3"]
        assert ra[0]["results"][0][0]["path"].endswith("File2.java")
        assert ra[1]["reloaded"] is True and ra[1]["rows"] == 8
        assert ra[2]["results"][0][0]["path"].endswith("Fresh.java")

        # second connection opened BEFORE the swap would have cached the
        # old manifest generation; a fresh connection after the swap (and
        # even one sharing the batcher mid-life) must format with the
        # new-generation manifest
        rb = list(server.serve(
            [{"id": "b1", "query": "public class File7 void method7"}],
            batcher=b,
        ))
        assert rb[0]["results"][0][0]["path"].endswith("File7.java")


def test_serve_batcher_submit_error_answers_not_kills(served):
    """A batcher.submit failure (e.g. the batcher closed underneath a
    live connection) answers an in-order error response — the stream
    survives, no orphaned meta entry desyncs later responses."""
    from better_search_rag_rust_tpu.batcher import DynamicBatcher

    b = DynamicBatcher(served.engine(), k=5, max_batch=8, window_ms=1.0)
    b.close()
    resps = list(served.serve(
        [
            {"id": 1, "query": "public class File1 void method1"},
            {"id": 2, "query": "public class File2 void method2"},
        ],
        batcher=b,
    ))
    assert [r["id"] for r in resps] == [1, 2]
    assert "closed" in resps[0]["error"]
    assert "closed" in resps[1]["error"]


def test_swap_engine_contract(served, tmp_path):
    """swap_engine pins its contract: dim mismatch raises (clients
    validated against the old dim), the generation window prunes to the
    last 8 manifests, and k re-resolves against the new store."""
    import numpy as np

    from better_search_rag_rust_tpu.batcher import DynamicBatcher
    from better_search_rag_rust_tpu.config import SearchConfig
    from better_search_rag_rust_tpu.ops import SearchEngine
    from better_search_rag_rust_tpu.parallel.mesh import create_mesh
    from better_search_rag_rust_tpu.store import DeviceStore

    mesh = create_mesh()
    engine = served.engine()
    with DynamicBatcher(engine, k=5, max_batch=8, window_ms=1.0) as b:
        wrong_dim = SearchEngine(
            DeviceStore.from_host(
                np.random.default_rng(0)
                .standard_normal((16, 32))
                .astype(np.float32),
                mesh,
            ),
            SearchConfig(top_k=5),
        )
        with pytest.raises(ValueError, match="dim"):
            b.swap_engine(wrong_dim)

        dim = engine.store.dim
        small = SearchEngine(
            DeviceStore.from_host(
                np.random.default_rng(1)
                .standard_normal((3, dim))
                .astype(np.float32),
                mesh,
            ),
            SearchConfig(top_k=5),
        )
        for i in range(12):
            gen = b.swap_engine(small, manifest=[f"gen{i}"] * 3)
        assert gen == 12
        # window: the current + 8 previous generations retained
        assert set(b.manifest_by_gen) == set(range(4, 13))
        assert b.k == 3  # re-resolved against the 3-row store
        # a swapped-in engine actually serves
        q = np.asarray(small.store.effective_matrix()[1], dtype=np.float32)
        ids, _ = b.submit(q).result()
        assert int(ids[0, 0]) == 1
    with pytest.raises(RuntimeError, match="closed"):
        b.swap_engine(small)


def test_serve_skips_manifest_registration_for_foreign_engine(served):
    """Round-4 ADVICE (medium): serve must register its manifest for the
    batcher's current generation ONLY when the batcher still serves the
    engine the manifest describes. If the pipeline rebuilt its engine
    (cache invalidated by an in-process update) while the batcher still
    holds the old one, registering the NEW store's manifest under the OLD
    engine's generation would format old-store row ids with new-store
    paths — silently row-shifted. The guard skips registration; futures
    fail safe to row:N."""
    import numpy as np

    from better_search_rag_rust_tpu.batcher import DynamicBatcher
    from better_search_rag_rust_tpu.config import SearchConfig
    from better_search_rag_rust_tpu.ops import SearchEngine
    from better_search_rag_rust_tpu.parallel.mesh import create_mesh
    from better_search_rag_rust_tpu.store import DeviceStore

    dim = served.engine().store.dim
    foreign = SearchEngine(
        DeviceStore.from_host(
            np.random.default_rng(3).standard_normal((20, dim))
            .astype(np.float32),
            create_mesh(),
        ),
        SearchConfig(top_k=5),
    )
    with DynamicBatcher(foreign, k=5, max_batch=8, window_ms=1.0) as b:
        resp = next(iter(served.serve(
            [{"id": 1, "query": "public class File3 void method3"}],
            batcher=b,
        )))
        # the pipeline's manifest was NOT registered for the foreign
        # engine's generation ...
        assert b.manifest_by_gen.get(b.generation) is None
        # ... so paths degrade to row:N (served by the batcher's OWN
        # engine — ids are that store's rows, never the pipeline store's
        # paths)
        assert all(r["path"] == f"row:{r['row']}"
                   for r in resp["results"][0])


def test_swap_engine_refuses_oom_double_residency(served, monkeypatch):
    """swap_engine's transient double-residency (old + new store live
    until in-flight handles drop) must not OOM mid-serve and kill the
    server (round-4 ADVICE): when old+new exceed 90% of addressable
    device memory the swap refuses up front with remediation guidance;
    force=True overrides for meshes with real headroom."""
    import numpy as np

    from better_search_rag_rust_tpu import batcher as B
    from better_search_rag_rust_tpu.batcher import DynamicBatcher
    from better_search_rag_rust_tpu.config import SearchConfig
    from better_search_rag_rust_tpu.ops import SearchEngine
    from better_search_rag_rust_tpu.parallel.mesh import create_mesh
    from better_search_rag_rust_tpu.store import DeviceStore

    mesh = create_mesh()
    engine = served.engine()
    dim = engine.store.dim
    other = SearchEngine(
        DeviceStore.from_host(
            np.random.default_rng(2).standard_normal((64, dim))
            .astype(np.float32),
            mesh,
        ),
        SearchConfig(top_k=5),
    )
    with DynamicBatcher(engine, k=5, max_batch=8, window_ms=1.0) as b:
        both = int(engine.store.data.nbytes) + int(other.store.data.nbytes)
        # a limit the pair cannot fit -> refuse, batcher unchanged
        monkeypatch.setattr(B, "_addressable_bytes_limit",
                            lambda arrays: both)
        with pytest.raises(RuntimeError, match="double-residency"):
            b.swap_engine(other)
        assert b.engine is engine and b.generation == 0
        # force overrides; and with headroom the same swap just works
        gen = b.swap_engine(other, force=True)
        assert gen == 1 and b.engine is other
        monkeypatch.setattr(B, "_addressable_bytes_limit",
                            lambda arrays: both * 4)
        assert b.swap_engine(engine) == 2
