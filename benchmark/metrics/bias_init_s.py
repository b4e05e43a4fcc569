"""bias_init_s: seconds of the profiled fit's ``cmfrec.engine.bias_init``
span (solvers/dense_masked.py:_device_bias_init, the alternating bias
start from the dense form), the larger of its host and device
durations."""

import fit_record


def read(run):
    return fit_record.seconds(fit_record.record(run),
                              "cmfrec.engine.bias_init")
