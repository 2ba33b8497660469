"""The wide-row frontier kernel's share of its roofline on the datastore's
retrievals of the served steps, replayed after the window (as
``frontier.roofline_share.knn``)."""
from perfbench.metrics._device import roofline_share


def read(sources):
    return roofline_share(sources, "wide")
