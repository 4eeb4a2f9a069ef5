"""Worker process for the 2-process jax.distributed integration test.

Launched by tests/test_multiprocess.py with BSR_COORDINATOR /
BSR_NUM_PROCESSES / BSR_PROCESS_ID set. Each process owns 4 emulated CPU
devices (8 global), ingests its file shard, host 0 merges, every host builds
the sharded device store from global.npy (reading only its own row
blocks) and runs the same search; host 0 writes the results JSON.

This executes the paths no single-process test can reach:
`_host_barrier` (multihost sync_global_devices), the cross-host
`process_allgather` in bench.gather_timings, and the per-host shard reads in
`DeviceStore.from_file_sharded` — the rebuild's analogue of the
reference's only distributed validation, running under mpiexec
(reference: makefile:13-14).
"""

import json
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    workdir = sys.argv[1]
    from better_search_rag_rust_tpu.launch import maybe_init_distributed

    assert maybe_init_distributed(), "BSR_* env not set?"
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, jax.devices()
    assert len(jax.local_devices()) == 4

    from better_search_rag_rust_tpu.config import (
        CorpusConfig,
        EncoderConfig,
        PipelineConfig,
        SearchConfig,
        StoreConfig,
    )
    from better_search_rag_rust_tpu.pipeline import Pipeline
    from better_search_rag_rust_tpu.store.vectorstore import (
        global_store_path,
        read_matrix_slice,
    )

    cfg = PipelineConfig(
        corpus=CorpusConfig(
            root=os.path.join(workdir, "corpus"),
            extensions=("java",),
            files_per_batch=3,
        ),
        encoder=EncoderConfig(backend="hash", dim=32, batch_size=3),
        store=StoreConfig(dir=os.path.join(workdir, "vstore")),
        search=SearchConfig(top_k=5, chunk_rows=64),
    )
    p = Pipeline(cfg)

    stats = p.ingest_shard()  # shard = process_index, num_shards = 2
    merged = p.merge()  # count is reported on host 0 only (root merge)
    if jax.process_index() == 0:
        assert merged > 0, "merge produced no rows"

    engine = p.engine()  # from_file_sharded over the global mesh
    queries = read_matrix_slice(global_store_path(cfg.store.dir), 0, 4)
    ids, dists = engine.search(queries, k=5)

    # Cross-host benchmark aggregation (process_allgather path).
    p.bench.record_duration("worker_op", 0.25 * (jax.process_index() + 1),
                            items=10)
    report = p.bench.generate_report()
    stats_json = p.bench.as_json()

    # ---- incremental update across the cluster -----------------------------
    # Host 0 mutates the corpus and performs the rewrite inside update();
    # host 1 only passes the barrier — its cached engine AND manifest must
    # invalidate (a stale manifest would silently row-shift its answers
    # after the deletion). Both hosts then rebuild collectively and run
    # the same query; the new file must resolve by PATH on host 0.
    corpus_root = os.path.join(workdir, "corpus")
    if jax.process_index() == 0:
        os.remove(os.path.join(corpus_root, "F03.java"))
        with open(os.path.join(corpus_root, "Fresh.java"), "w") as f:
            f.write("class Fresh { int meteorite; }")
    upd = p.update()
    if jax.process_index() == 0:
        assert upd.rows_deleted == 1 and upd.embeddings == 1, upd

    ranked = p.query(["class Fresh int meteorite"], k=3)[0]
    post_update_rows = int(p.engine().store.num_rows)

    if jax.process_index() == 0:
        out = {
            "merged": merged,
            "files_assigned": stats.files_assigned,
            "ids": ids.tolist(),
            "dists": dists.tolist(),
            "report_has_worker_op": "worker_op" in report,
            "bench": json.loads(stats_json),
            "post_update_rows": post_update_rows,
            "post_update_path": ranked[0][0],
        }
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump(out, f)

    # Leave cleanly (coordinator teardown).
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
