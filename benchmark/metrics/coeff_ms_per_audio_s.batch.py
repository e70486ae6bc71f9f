"""The whole-clip coefficient program (mel frontend and BFMNet,
``Synthesizer.predict_expressions``), host clock to a synchronise, summed
over the cycle's clips: ms per second of audio."""


def read(data):
    ms, audio = data.get("coeff_ms"), data.get("audio_s")
    return sum(ms) / audio if ms and audio else None
