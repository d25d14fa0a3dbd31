"""The bytes the port's lang directory holds, from the JAX package's
directory: every file the same, but phones.txt and phones/disambig.int,
which list every disambiguation symbol that L_disambig.fst uses, #0 to
#k, where the JAX package lists #0 alone (ROADMAP.md section 3)."""

import os

from kaldi_tpu.fstext.openfst_io import read_fst_file


def disambig_added(jax_dir):
    """[(k, id)] of the symbols #1.. that the port adds to JAX's lists;
    asserts that together they cover L_disambig.fst's inputs."""
    with open(os.path.join(jax_dir, "phones", "disambig.int")) as f:
        listed = [int(x) for x in f.read().split()]
    assert len(listed) == 1
    first = listed[0]
    L = read_fst_file(os.path.join(jax_dir, "L_disambig.fst"))
    used = {a.ilabel for arcs in L.arcs for a in arcs if a.ilabel >= first}
    last = max(used, default=first)
    added = [(k, first + k) for k in range(1, last - first + 1)]
    assert used <= {first} | {i for _, i in added}
    return added


def expected_bytes(jax_dir, name):
    name = name.removeprefix("lang/")
    with open(os.path.join(jax_dir, name), "rb") as f:
        data = f.read()
    if name == "phones.txt":
        return data + "".join(f"#{k} {i}\n" for k, i in
                              disambig_added(jax_dir)).encode()
    if name == "phones/disambig.int":
        return data + "".join(f"{i}\n" for _, i in
                              disambig_added(jax_dir)).encode()
    return data
