"""fit_peak_gib: torch.cuda.max_memory_allocated() over the window's fits
(reset before the window), in GiB."""


def read(run):
    if run.device.type != "cuda" or not run.fits:
        return None
    return run.peak_bytes / 2 ** 30
