"""Test harness: emulate an 8-device mesh on CPU.

The reference has no multi-process test at all — its distributed layer is
only validated by running the binary under mpiexec (SURVEY.md §4). JAX lets
us do better: XLA's host-platform device-count flag gives every test a real
8-way mesh, so the sharded search path, collectives and merge logic run in CI
exactly as they do across chips.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

assert len(jax.devices()) == 8, (
    f"test harness expected 8 emulated CPU devices, got {jax.devices()}"
)


@pytest.fixture(scope="session")
def mesh8():
    from better_search_rag_rust_tpu.parallel import create_mesh

    return create_mesh()


@pytest.fixture(scope="session")
def mesh1():
    import jax

    from better_search_rag_rust_tpu.parallel import create_mesh

    return create_mesh(devices=jax.devices()[:1])
