"""The least time of the traced window's work over the device's busy
time, in percent. The least time comes from the spec and the shapes
alone (``bench/roofline.py``): ``taps`` f32 operations an interior point
a sweep at 67 TFLOP/s against the grid read and written once a solve at
3.35 TB/s, the larger of the two."""


def read(ctx):
    if "least_time_s" not in ctx or not ctx.get("busy_s"):
        return None
    return 100.0 * ctx["least_time_s"] / ctx["busy_s"]
