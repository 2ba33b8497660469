"""The port's distributed-runtime pieces: the checkpoint format and int8
gradient compression."""
