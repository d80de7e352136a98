"""The port's graft entry twin, ``__graft_entry_torch__.py``: its forward
step equals the JAX package's entry() on the same chunk, and the
multi-process dry run holds every key on the rank of its hash class with
exact counts."""

import jax
import numpy as np
import torch

import __graft_entry__ as ref_entry
import __graft_entry_torch__ as g


def test_entry_matches_reference():
    fn, (chunk, doc) = g.entry("cpu")
    assert chunk.device == torch.device("cpu") and chunk.dtype == torch.uint8 and doc == 0
    update, ovf = fn(chunk, doc)
    ref_fn, ref_args = ref_entry.entry()
    assert np.array_equal(chunk.numpy(), np.asarray(ref_args[0]))
    want, want_ovf = jax.jit(ref_fn)(*ref_args)
    assert int(ovf) == int(want_ovf) == 0
    got = update.to_numpy()
    for lane, (a, b) in zip(("k1", "k2", "value", "valid"), zip(got, want)):
        assert np.array_equal(a, np.asarray(b)), lane
    assert int(update.valid.sum()) == 8  # the sentence's distinct words


def test_dryrun_multichip_two_processes(capsys):
    g.dryrun_multichip(2)
    assert "dryrun_multichip(2): ok — " in capsys.readouterr().out
