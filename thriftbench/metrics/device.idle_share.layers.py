"""Share of the traced slice the device idled inside the model's own layer
marks: the seconds of the slice's ``idle_gaps`` whose innermost open span is
an ``arm.mla.*`` or ``arm.moe.*`` mark of the program, over ``window_s``. It
sees the ten longest gap names the slice keeps (``profile.parse``): a mark
whose gaps fall below those is not counted."""

MARKS = ("arm.mla.", "arm.moe.")


def read(ctx):
    sl = ctx["slice"]
    if sl is None or sl["window_s"] <= 0:
        return None
    return sum(s for name, s in sl["idle_gaps"] if name.startswith(MARKS)) / sl["window_s"]
