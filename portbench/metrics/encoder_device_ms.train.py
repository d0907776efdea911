"""Device time per IL update of the kernels launched in the
``train_encode`` range of the training forward (the encoders over all T
* N rows), in ms."""

from portbench import trace


def read(summary):
    return trace.range_ms(summary, "train_encode")
