"""device_idle_share.train: the card's idle share of the traced steps of a
schedule unit, in %."""

from portbench.metrics._idle import idle_percent


def read(r):
    return idle_percent(r)
