"""A private build of the JAX package's native library for the port's
parity tests.

`kaldi_tpu/native.py` compiles `native/kt_native.cpp` with g++ straight
into the shared `native/build/libkt_native.so` and loads it from there.
Under pytest-xdist several workers may build or load that file at once,
and a worker that loads a half-written library gets no library at all.
The fixture below gives the reference's loader a directory of the
test module's own for as long as the module runs, then restores the
loader's state; nothing in `kaldi_tpu/` changes."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def private_jax_native_build(tmp_path_factory):
    from kaldi_tpu import native
    build = str(tmp_path_factory.mktemp("kt_native"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_build_dir", lambda: build)
        mp.setattr(native, "_LIB", None)
        mp.setattr(native, "_TRIED", False)
        yield build
