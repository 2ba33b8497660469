"""One driver per kind of traffic mix: ``traffic/<mix>.json`` names its
``kind``, and ``drivers/<kind>.py`` runs it (``run(ctx) -> Outcome``)."""
