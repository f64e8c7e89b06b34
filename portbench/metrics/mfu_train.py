"""The learner's update's share of the card's peak, in %: the model FLOPs
of one train step's update (roofline.update_flops: a forward and a backward
over the whole trajectory in each epoch, from the configuration's widths by
its policy's plain reference) over the learner's own time for GAE and the
update (its span ``split["update_s"]``, which waits on the device before and
after; the mean of the calls timed after the window) and the dense peak of
the configuration's compute precision. None without the spans or a model."""


def read(r):
    spans = [s["update_s"] for s in getattr(r, "splits", ()) if "update_s" in s]
    flops = getattr(r, "update_flops", None)
    if not spans or not flops:
        return None
    return 100.0 * flops / (sum(spans) / len(spans)) / r.peak_flops
