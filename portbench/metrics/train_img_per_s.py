"""train_img_per_s: images of every iteration completed in the window
(lazy-R1 and path-regularised ones as they fall) over the window's time
(host clock, to the last iteration synchronised)."""


def read(run):
    return sum(u["images"] for u in run.units) / run.window_s
