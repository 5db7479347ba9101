"""The port's quickstart (`python -m repro_torch.examples.quickstart
--device cpu`) against the reference's `examples/quickstart.py`: both
converge, and their eigenvalues agree at rtol 1e-5 (each solve draws its
own start block, so only the converged spectrum is compared)."""
import importlib.util
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_quickstart(capsys):
    spec = importlib.util.spec_from_file_location(
        "ref_quickstart", os.path.join(REPO, "examples", "quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}
    eigsh = mod.eigsh

    def recording_eigsh(*args, **kw):
        got["res"] = eigsh(*args, **kw)
        return got["res"]

    mod.eigsh = recording_eigsh
    mod.main()
    capsys.readouterr()
    return got["res"]


def test_quickstart_matches_reference(capsys):
    from repro_torch.examples import quickstart
    ref = _reference_quickstart(capsys)
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "IOStats:" in out and "converged=True" in out
    assert ref.converged and res.converged
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(ref.eigenvalues), rtol=1e-5)
