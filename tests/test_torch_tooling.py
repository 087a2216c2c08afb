"""The port's diagnostics (``python -m nf4_tpu_torch.diagnostics``) and
installer (``python -m nf4_tpu_torch.install``) on the CPU, as
``tests/test_tooling.py`` runs the JAX package's.  Their kernel sections
run on the card (``tests/test_torch_cuda.py -k diagnostics``)."""

from _torch_threads import _one_thread  # noqa: F401

from nf4_tpu_torch import diagnostics, install


def test_diagnostics_cpu_checks(capsys):
    diagnostics.failures.clear()
    diagnostics.env_report()
    diagnostics.backend_check()
    out = capsys.readouterr().out
    assert "[FAIL]" not in out
    assert diagnostics.failures == []
    for line in ("torch:", "nvcc:", "g++:", "card:", "NF4TPU_NATIVE", "method='native' gives the oracle's bytes",
                 "without a card, quantize_for_tpu() (default device cuda) raises", "invalid NF4TPU_NATIVE rejected"):
        assert line in out, line


def test_diagnostics_without_a_card_fail_the_kernel_sections(capsys):
    """No card: the kernel sections record their failure and ``main``
    exits 1 (exit 0 only when every check passed)."""
    assert diagnostics.main() == 1
    out = capsys.readouterr().out
    assert diagnostics.failures == ["no CUDA device: the kernels cannot be built and launched here",
                                    "no CUDA device: kernels A and F cannot run here"]
    assert "Triage summary" in out and "2 failure(s)" in out


def test_diagnostics_reject_an_invalid_native_flag(monkeypatch, capsys):
    """The check itself fails when the flag is not rejected."""
    from nf4_tpu_torch.nf4 import native

    monkeypatch.setattr(native, "mode", lambda: "auto")
    diagnostics.failures.clear()
    diagnostics.backend_check()
    assert diagnostics.failures == ["invalid NF4TPU_NATIVE rejected"]
    capsys.readouterr()


def test_installer_smoke():
    assert install.detect_platform() == "cpu"
    assert install.smoke_test()


def test_installer_main(capsys):
    assert install.main(["--skip-install"]) == 0
    out = capsys.readouterr().out
    assert "64x64 round trip ok on cpu" in out and "python -m nf4_tpu_torch.diagnostics" in out
