import os
import sys

# Tests run on the CPU unless JAX_PLATFORMS says otherwise, on 8 virtual
# devices so the mesh paths run without several cards.  Tests marked
# `gpu` need the real card and skip elsewhere (see the `_gpu_only`
# fixture and the README's command for running them on the GPU).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

# ---------------------------------------------------------------- tiering
# Files listed here are auto-marked `slow` (big XLA CPU compiles, minutes
# each); everything else is marked `fast`.  The default gate is
#     python -m pytest tests/ -m "not slow" -q
# and the full suite (fast + slow) stays the bar for codec changes.
SLOW_FILES = {
    "test_g729_encoder_tpu.py",
    "test_g729_tpu.py",
}


def pytest_collection_modifyitems(config, items):
    seen = set()
    for item in items:
        fname = os.path.basename(str(item.fspath))
        seen.add(fname)
        if fname in SLOW_FILES:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.fast)
    # a renamed/removed SLOW_FILES entry would silently move minutes of
    # compiles into the fast gate — fail loudly.
    # Only checked on directory-level collection (explicit-file runs
    # legally collect a subset).
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    dir_run = any(
        os.path.isdir(a.split("::")[0]) and os.path.samefile(
            a.split("::")[0], tests_dir)
        for a in config.args if os.path.exists(a.split("::")[0]))
    if dir_run:
        # only flag entries that no longer EXIST (renamed/deleted) —
        # a --ignore/--deselect run legitimately collects a subset
        stale = {f for f in SLOW_FILES - seen
                 if not os.path.exists(os.path.join(tests_dir, f))}
        assert not stale, (
            f"conftest.SLOW_FILES entries match no test file on disk "
            f"(renamed?): {sorted(stale)}")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked `gpu` run only where JAX's platform is the GPU; the
    check runs per test, never at import or collection."""
    if request.node.get_closest_marker("gpu") is not None:
        from amv_tpu import backend
        if backend.platform() != "gpu":
            pytest.skip("needs an NVIDIA GPU (JAX platform is "
                        f"{backend.platform()!r})")


@pytest.fixture(scope="session")
def sample_amv_bytes():
    """The seeded library clip (amv_tpu/verify/corpus.py): 128x96 at
    12 fps, 48 frames with 16 kHz ADPCM audio, made by the C reference
    encoder and the scalar ADPCM oracle."""
    from amv_tpu.verify.corpus import library_clip
    return library_clip(128, 96, fps=12, seconds=4.0, sample_rate=16000,
                        seed=2026)


@pytest.fixture(scope="session")
def sample_amv_path(sample_amv_bytes, tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "lib128.amv"
    path.write_bytes(sample_amv_bytes)
    return str(path)
