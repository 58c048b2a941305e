"""Test configuration.

JAX tests run on a virtual 8-device CPU mesh
(``--xla_force_host_platform_device_count=8``) so the multi-device
sharding paths are exercised without accelerator hardware, per SURVEY.md
§4.  The env vars must be set before jax is first imported, hence this
conftest sets them at collection time.  Set TOKENIZER_TEST_DEVICE=1 to
leave the platform to JAX instead: the tests then run on the machine's
accelerator, and the ones marked ``gpu`` (which skip on the CPU) run too:

    TOKENIZER_TEST_DEVICE=1 python -m pytest tests/ -m gpu
"""

import os
import sys
from pathlib import Path

import pytest

if not os.environ.get("TOKENIZER_TEST_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    if "jax" in sys.modules:
        # A plugin imported jax before this conftest ran, so it has read
        # the environment already.
        sys.modules["jax"].config.update("jax_platforms", "cpu")

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")

# Golden conformance data is vendored in-repo (tests/testdata — the
# conformance corpus and committed id arrays, the same shared constants
# the reference commits in its test trees), with the reference checkout
# as a secondary source when mounted.
TESTDATA_DIRS = [
    REPO / "tests" / "testdata",
    REFERENCE / "tokenizer_ts" / "test" / "testdata",
    REFERENCE / "Tokenizer_C#" / "TokenizerTest" / "testData",
]


def find_testdata(name: str):
    for d in TESTDATA_DIRS:
        p = d / name
        if p.is_file():
            return p
    return None


@pytest.fixture(scope="session")
def lib_rs_text():
    p = find_testdata("lib.rs.txt")
    if p is None:
        pytest.skip("reference conformance corpus not available")
    return p.read_text(encoding="utf-8")


def has_vocab(encoding: str) -> bool:
    from tokenizer_tpu.vocab import resolve_vocab_file

    try:
        resolve_vocab_file(encoding, allow_fetch=False)
        return True
    except (FileNotFoundError, ValueError):
        return False


def require_vocab(encoding: str):
    if not has_vocab(encoding):
        pytest.skip(f"{encoding} rank file not available offline")


@pytest.fixture(scope="session")
def gpt2_vocab():
    require_vocab("gpt2")
    from tokenizer_tpu.vocab import Vocabulary

    return Vocabulary.for_encoding("gpt2", allow_fetch=False)


@pytest.fixture(scope="session")
def gpt2_pair_table(gpt2_vocab):
    return gpt2_vocab.pair_table()


@pytest.fixture(scope="session")
def gpt2_tokenizer():
    require_vocab("gpt2")
    from tokenizer_tpu import create_by_encoder_name

    return create_by_encoder_name("gpt2", allow_fetch=False)


@pytest.fixture
def gpu_device():
    """The first JAX device, or a skip when it is not a GPU.

    Decided here, at run time, never at import: every xdist worker must
    collect the same tests.
    """
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
