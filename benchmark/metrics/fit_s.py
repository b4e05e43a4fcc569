"""fit_s: seconds a fit, over the whole window: (end of the last fit -
start of the first) / fits, each ending in torch.cuda.synchronize()."""


def read(run):
    return run.fit_s
