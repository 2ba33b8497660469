"""The port's distributed-runtime pieces: so far the checkpoint format."""
