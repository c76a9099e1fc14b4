"""pad_ms.serve: the median of the engine's ``pad_ms`` per batch
(``GLCMEngine.stats()``: stacking the requests on the host)."""


def read(rec):
    eng = rec.get("engine")
    if not eng or not eng["pad_ms"]["n"]:
        return None
    return eng["pad_ms"]["p50"]
