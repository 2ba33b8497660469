"""The three-term roofline on the H100 (``analysis``) and the op counts of
one rank's step that feed it (``counts``)."""
