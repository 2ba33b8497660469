"""Host milliseconds of a decode step's kNN-LM part (the datastore's
retrieval and the mix, ``make_knnlm_mixer``'s function, and the argmax),
from the end of the model part's synchronise to a synchronise after it,
averaged over the counting third's mixed steps."""


def read(sources):
    laps = (sources.get("counts") or {}).get("laps") or []
    ms = [lap["mix_ms"] for lap in laps if lap.get("mix_ms") is not None]
    return None if not ms else sum(ms) / len(ms)
