"""Device: one minus the union of the device's intervals over the
profiled slice's host span, in percent."""


def read(run):
    return None if run.slice is None else 100.0 * run.slice["idle_share"]
