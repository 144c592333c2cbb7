"""PyTorch port: the graft entry (``dhqr_tpu_torch.graft_entry``) and the
dry run (``dhqr_tpu_torch._dryrun``), the twins of ``__graft_entry__.py``
and ``dhqr_tpu/_dryrun.py``, on the CPU.

``entry()``'s step is held to the JAX package's ``__graft_entry__.entry()``
step on the same numpy problem at 1e-4 relative (float32), and its
normal-equations residual below 1e-2 as in ``tests/test_graft_entry.py``.
The dry run's first mesh stages run on two gloo ranks, and a few of its
single-process stages in process; the whole dry run on two ranks is a
slow test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dhqr_tpu_torch import _dryrun, graft_entry  # noqa: E402
from dhqr_tpu_torch.interop import to_numpy  # noqa: E402
from dhqr_tpu_torch.ops import blocked  # noqa: E402


def test_entry_compiles_and_solves():
    fn, (A, b) = graft_entry.entry(device="cpu")
    assert A.shape == (256, 128) and A.dtype == torch.float32
    A0 = A.clone()
    x = fn(A, b)
    assert x.shape == (A.shape[1],)
    assert torch.equal(A, A0)  # the step factors a copy
    r = to_numpy(A.T @ (A @ x - b))
    assert np.linalg.norm(r) < 1e-2  # f32 normal-equations residual


def test_entry_matches_the_reference_step():
    import __graft_entry__ as g

    fn, (A, b) = graft_entry.entry(device="cpu")
    jfn, _ = g.entry()
    x = to_numpy(fn(A, b))
    xj = np.asarray(jax.jit(jfn)(jnp.asarray(to_numpy(A)),
                                 jnp.asarray(to_numpy(b))))
    assert np.linalg.norm(x - xj) <= 1e-4 * np.linalg.norm(xj)


def test_entry_takes_the_kernel_flag_auto_resolves_to(monkeypatch):
    """On the card "auto" resolves to the panel kernel for float32, and the
    step then launches it once per 32-wide panel (4 for 128 columns); on
    the CPU it resolves to the plain loop. Here the resolution is forced
    to the kernel, whose wrapper runs its plain version on a CPU tensor."""
    fn, (A, b) = graft_entry.entry(device="cpu")
    calls = []

    def counting(real):
        def count(panel, offset, *args, **kwargs):
            calls.append(tuple(panel.shape))
            return real(panel, offset, *args, **kwargs)
        return count

    for name in ("_panel_qr_kernel", "_panel_qr_kernel_in_place"):
        monkeypatch.setattr(blocked, name, counting(getattr(blocked, name)))
    x_plain = fn(A, b)
    assert calls == []
    monkeypatch.setattr(blocked, "_resolve_kernel", lambda *a: True)
    fn, _ = graft_entry.entry(device="cpu")
    x_kernel = fn(A, b)
    assert len(calls) == 4
    assert torch.allclose(x_kernel, x_plain, rtol=1e-4, atol=1e-5)


def test_dryrun_first_stages_on_two_ranks(capfd):
    seconds = _dryrun.run(2, device="cpu",
                          stages=("layouts", "pipeline", "awkward"))
    out = capfd.readouterr().out
    for line in ("dryrun: sharded_lstsq layout=block ok",
                 "dryrun: sharded_lstsq layout=cyclic ok",
                 "dryrun: sharded_lstsq agg_panels=2 lookahead ok",
                 "dryrun: pipeline ok", "dryrun: sharded_lstsq awkward"):
        assert line in out, out
    assert set(seconds) == {"layouts", "pipeline", "awkward", "spawn"}


def test_dryrun_single_process_stages(capfd):
    _dryrun.run(1, device="cpu", stages=("serve", "numeric", "sketch"))
    out = capfd.readouterr().out
    for stage in ("serve batched_lstsq", "numeric", "sketch"):
        assert f"dryrun: {stage} ok" in out, out


def test_dryrun_refuses_an_unknown_stage():
    with pytest.raises(ValueError, match="unknown dry-run stages"):
        _dryrun.run(2, device="cpu", stages=("layouts", "lint"))


@pytest.mark.slow
def test_dryrun_multichip_two_ranks(capsys):
    graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun: pod SKIPPED" in out
    assert out.rstrip().endswith("dryrun: all paths ok")
