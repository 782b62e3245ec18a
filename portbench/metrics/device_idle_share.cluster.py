"""device_idle_share.cluster: the card's idle share of the traced steps of a
clustering job, in %."""

from portbench.metrics._idle import idle_percent


def read(r):
    return idle_percent(r)
