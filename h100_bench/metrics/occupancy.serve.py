"""occupancy.serve: requests served over the bucket slots launched, from
``GLCMEngine.stats()``'s ``batch_occupancy``, in %."""


def read(rec):
    eng = rec.get("engine")
    if not eng:
        return None
    occ = eng["batch_occupancy"]
    slots = sum(int(b) * n for b, h in occ.items() for n in h.values())
    used = sum(int(k) * n for h in occ.values() for k, n in h.items())
    return 100.0 * used / slots if slots else None
