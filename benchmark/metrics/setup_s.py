"""setup_s: seconds from the run's start to its window's: imports, the
kernels built or loaded from build/, the data drawn and the warm-up fits
(harness.WARM_FITS of them)."""


def read(run):
    return run.setup_s
