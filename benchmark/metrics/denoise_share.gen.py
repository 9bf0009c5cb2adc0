"""Percent of the requests' device time inside AnimationPipeline.denoise
(CUDA events around denoise and around each generate_videos call)."""


def read(rec):
    total = sum(rec.events.get("request", []))
    part = sum(rec.events.get("denoise", []))
    return 100.0 * part / total if total > 0 and part > 0 else None
