"""One-command real-weights acceptance gate of the port (the counterpart of
tools/validate_weights.py; docs/REAL_WEIGHTS.md is that gate's runbook).

Pointed at a directory of published artifacts, it runs every loader of the
port over them and requires 0 fresh / 0 unused keys, up to the runbook's
allowances, then loads the tensors into the module:

    python3 -m asva_tpu_torch.tools.validate_weights --root /data/artifacts \
        --checkpoint_modules_dir /data/.../checkpoint-37000/modules \
        --avsync_modules_dir /data/.../checkpoint-40000/modules \
        --avid_cma_path /data/.../AVID_CMA.tar [--device cuda] [--run_tests]

    python3 -m asva_tpu_torch.tools.validate_weights --fabricate \
        [--full] [--device cpu]

`--fabricate` writes the whole inventory in its published formats and key
spaces (`asva_tpu_torch.tools.fabricate`, tiny unless `--full`) into a
temporary directory (or into `--root` when it is given, and kept there) and
runs the gate over it.

Each check is PASS, FAIL or NOT-STAGED with its counts (converted, fresh =
module keys the file lacks, unused = file keys no module key takes,
mismatched shapes); the exit code is 1 when any check fails.  A check
decides through `convert.load_report`, the decision the loaders make
(`runtime.load_weights`, `convert.load_source_state`): it passes when the
loader would load the file, and what the loader allows fresh or drops is
within the runbook's allowances for that check:
  sd15_unet_graft     fresh only the `_temp`/`_audio` keys;
  sd15_text_encoder   unused only `position_ids`;
  imagebind_huge_*    the audio tower fresh only `final_layer_norm`; unused
                      only the other towers' keys and the logit scales
                      (`modality_postprocessors.*`), which no tower reads;
  fid_inception_v3    unused only `fc.*` (FID reads the pool features);
  fvd_i3d             the BatchNorm eps read out of the blob is printed;
  avid_cma_init       fresh only the classifier's `head`;
  null_text_encoding  shape (1, 77, 768), finite.
Every other check requires an exact match.

`--run_tests` ends with the port's loader parity files
(tests/test_torch_{convert,weights,text,vae_audio}.py) under pytest; they
hold the port against asva_tpu, so they need a machine with JAX.  The JAX
gate's golden mints (mel and scheduler fixtures) are not part of this gate:
they need torchaudio and diffusers, and both packages' tests read the same
committed fixtures.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import List, Optional, Tuple

import torch

PASS, FAIL, MISS = "PASS", "FAIL", "NOT-STAGED"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PARITY_TESTS = ("tests/test_torch_convert.py", "tests/test_torch_weights.py",
                "tests/test_torch_text.py", "tests/test_torch_vae_audio.py")
NOTHING = r"$^"


def _find(*paths) -> Optional[str]:
    for p in paths:
        if p and os.path.isfile(p):
            return p
    return None


def judge(report, allowed_fresh: str = NOTHING,
          allowed_unused: str = NOTHING) -> Tuple[str, str]:
    """(PASS or FAIL, counts and the first offending keys) of a
    `convert.LoadReport` under a check's allowances."""
    bad = []
    if report.missing:
        bad.append(f"missing {report.missing[:4]}")
    if report.unexpected:
        bad.append(f"unexpected {report.unexpected[:4]}")
    if report.mismatched:
        bad.append(f"shapes {report.mismatched[:2]}")
    fresh = [k for k in report.missing_allowed
             if not re.search(allowed_fresh, k)]
    unused = [k for k in report.dropped if not re.search(allowed_unused, k)]
    if fresh:
        bad.append(f"fresh beyond the allowance {fresh[:4]}")
    if unused:
        bad.append(f"unused beyond the allowance {unused[:4]}")
    detail = report.counts() + ("; BAD " + "; ".join(bad) if bad else "")
    return (FAIL if bad else PASS), detail


class Gate:
    """The 13 checks over one artifact tree, at the published sizes or
    (`full=False`) at the tiny sizes of a fabricated tree."""

    def __init__(self, args, full: bool = True):
        self.args, self.full, self.device = args, full, args.device
        self.results: List[dict] = []
        self._cache = {}

    def record(self, label, status, detail="", **info):
        self.results.append(dict(label=label, status=status, detail=detail,
                                 **info))
        print(f"  [{status:^10s}] {label:24s} {detail}", flush=True)

    def state(self, path):
        from ..runtime import load_torch_state
        if path not in self._cache:
            self._cache = {path: load_torch_state(path)}   # one file held
        return self._cache[path]

    def check(self, label, path, build, space=None, graft=False,
              allowed_fresh=NOTHING, allowed_unused=NOTHING, missing="",
              state=None, note="", **info):
        """Report the file `path` (or the loaded `state`) against the
        module `build()` makes, and load it when the report passes."""
        from ..convert import load_exported, load_report
        if path is None:
            self.record(label, MISS, missing)
            return
        try:
            module = build()
            report = load_report(module, self.state(path) if state is None
                                 else state, space, graft)
            status, detail = judge(report, allowed_fresh, allowed_unused)
            if status == PASS:
                load_exported(module, report.state,
                              strict=not report.missing_allowed)
            del module
        except Exception as e:       # an unreadable file fails its check
            status, detail = FAIL, f"{type(e).__name__}: {e}"[:400]
        self.record(label, status, detail + note, **info)

    # -- the modules, allocated in fp32 on the device and not initialised:
    # every tensor a check passes is loaded from the file, and a module
    # whose check fails is dropped
    def _empty(self, factory):
        with torch.device("meta"):
            module = factory()
        return module.to_empty(device=self.device).float()

    def _checkpoint_configs(self):
        """The UNet and audio tower of a trained checkpoint: its
        modules_config.json where it has one (the port's own exports),
        else the gate's sizes."""
        from ..models.imagebind_audio import ImageBindAudioConfig
        from ..models.unet3d import UNet3DConfig
        from ..runtime import _config_from_dict, load_module_configs
        from .fabricate import configs
        cfg = configs(self.full)
        unet, audio, n_segment = cfg["unet"], cfg["audio"], cfg["n_segment"]
        saved = load_module_configs(self.args.checkpoint_modules_dir) or {}
        if "unet" in saved:
            unet = _config_from_dict(UNet3DConfig, saved["unet"])
        if "audio_encoder" in saved:
            audio = _config_from_dict(ImageBindAudioConfig,
                                      saved["audio_encoder"])
            n_segment = saved["audio_encoder"].get("n_segment", n_segment)
        return unet, audio, n_segment

    def run_all(self):
        from .. import runtime
        from ..convert import extract_state_and_eps
        from ..models.avsync import AVSyncClassifier
        from ..models.clip_text import CLIPTextModel
        from ..models.evalnets import InceptionI3D, InceptionV3FID
        from ..models.imagebind_audio import SegmaskAudioEncoder
        from ..models.imagebind_extra import (ImageBindTextEncoder,
                                              ImageBindVisionEncoder)
        from ..models.unet3d import AudioUNet3D
        from ..models.vae import AutoencoderKL
        from .fabricate import configs
        a, cfg, empty = self.args, configs(self.full), self._empty
        sd = os.path.join(a.root, "pretrained", "stable-diffusion-v1-5")

        def weights(d):
            return runtime._find_weights(d) if d and os.path.isdir(d) \
                else None

        self.check("sd15_vae", weights(os.path.join(sd, "vae")),
                   lambda: empty(lambda: AutoencoderKL(cfg["vae"])),
                   missing=f"no weights under {sd}/vae")
        # the 2D -> 3D graft: the _temp/_audio layers stay fresh by design
        self.check("sd15_unet_graft", weights(os.path.join(sd, "unet")),
                   lambda: empty(lambda: AudioUNet3D(cfg["unet"])),
                   graft=True, allowed_fresh=r"temp|audio",
                   missing=f"no weights under {sd}/unet")
        self.check("sd15_text_encoder",
                   weights(os.path.join(sd, "text_encoder")),
                   lambda: empty(lambda: CLIPTextModel(cfg["text_encoder"])),
                   space="clip_text", allowed_unused=r"position_ids",
                   missing=f"no weights under {sd}/text_encoder")

        mdir = a.checkpoint_modules_dir
        unet_cfg, audio_cfg, n_segment = self._checkpoint_configs()
        for label, sub, build, space in (
                ("avsyncd_unet", "unet",
                 lambda: empty(lambda: AudioUNet3D(unet_cfg)), None),
                ("avsyncd_audio_encoder", "audio_encoder",
                 lambda: empty(lambda: SegmaskAudioEncoder(audio_cfg,
                                                           n_segment)),
                 "imagebind_audio")):
            path = runtime.resolve_weights(os.path.join(mdir, sub)) \
                if mdir else None
            self.check(label, path, build, space=space,
                       missing="--checkpoint_modules_dir not staged")

        # imagebind_huge.pth carries every modality: per tower, no key of
        # its own may go unused; the segment tower's final_layer_norm is
        # the reference's own addition and stays fresh
        huge = _find(os.path.join(a.root, "pretrained", ".checkpoints",
                                  "imagebind_huge.pth"),
                     os.path.join(a.root, "pretrained", "imagebind_huge.pth"))
        towers = {
            "audio": lambda: SegmaskAudioEncoder(cfg["audio"],
                                                 cfg["n_segment"]),
            "vision": lambda: ImageBindVisionEncoder(cfg["vision"]),
            "text": lambda: ImageBindTextEncoder(cfg["imagebind_text"])}
        for tower, factory in towers.items():
            self.check(f"imagebind_huge_{tower}", huge,
                       lambda factory=factory: empty(factory),
                       space=f"imagebind_{tower}",
                       allowed_fresh=(r"^final_layer_norm\." if tower ==
                                      "audio" else NOTHING),
                       allowed_unused=(rf"^modality_(?!\w+\.{tower}\.)"
                                       r"|^modality_postprocessors\."),
                       missing="imagebind_huge.pth not staged")

        fid = _find(os.path.join(a.root, "pretrained",
                                 "pt_inception-2015-12-05-6726825d.pth"),
                    os.path.join(a.root, "pretrained", "pt_inception.pth"))
        self.check("fid_inception_v3", fid, lambda: empty(InceptionV3FID),
                   space="inception_v3",
                   allowed_unused=r"^fc\.|num_batches_tracked",
                   missing="FID blob not staged")

        blob = _find(os.path.join(a.root, "pretrained", "i3d_torchscript.pt"))
        try:
            state, eps = extract_state_and_eps(blob) if blob else (None,
                                                                   None)
        except Exception as e:
            self.record("fvd_i3d", FAIL, f"{type(e).__name__}: {e}"[:400])
        else:
            self.check("fvd_i3d", blob, lambda: empty(lambda: InceptionI3D(
                400, 1e-5 if eps is None else eps)), space="i3d",
                allowed_unused=r"num_batches_tracked", state=state,
                note=("; bn_eps=" + (f"auto:{eps}" if eps is not None
                                     else "default:1e-5")),
                missing="i3d_torchscript.pt not staged", bn_eps=eps)
            del state

        cdir = a.avsync_modules_dir
        files = {}
        if cdir and os.path.isdir(cdir):
            for mod in ("audio_encoder", "video_encoder", "head"):
                p = runtime.resolve_weights(os.path.join(cdir, mod))
                if p:
                    files[mod] = p
        merged = {f"{mod}.{k}": v for mod, p in files.items()
                  for k, v in runtime.load_torch_state(p).items()}
        self.check("avsync_classifier", cdir if files else None,
                   lambda: empty(AVSyncClassifier), state=merged,
                   missing=(f"no module weights under {cdir}" if cdir else
                            "--avsync_modules_dir not staged"))
        del merged

        self.avid_cma()
        self.null_text()
        return self.results

    def avid_cma(self):
        """The raw AVID-CMA tar into both encoders: every encoder key from
        the file, only the head fresh, nothing of the file unused."""
        from .. import runtime
        path = self.args.avid_cma_path
        if not (path and os.path.isfile(path)):
            self.record("avid_cma_init", MISS, "--avid_cma_path not staged")
            return
        try:
            from ..models.avsync import AVSyncClassifier
            model = self._empty(AVSyncClassifier)
            rep = runtime.init_avsync_from_avid_cma(model, path)
            fresh = sorted(k for k in model.state_dict()
                           if k not in set(rep["loaded"])
                           and not k.endswith("num_batches_tracked"))
            bad = [f"{kind} {keys[:4]}" for kind, keys in (
                ("missing", rep["missing"]),
                ("fresh beyond the allowance",
                 [k for k in fresh if not k.startswith("head.")]),
                ("unused", [k for k in rep["unused"]
                            if "num_batches_tracked" not in k])) if keys]
            detail = (f"{len(rep['loaded'])} converted, {len(fresh)} fresh, "
                      f"{len(rep['unused'])} unused")
            status = FAIL if bad else PASS
            if bad:
                detail += "; BAD " + "; ".join(bad)
        except Exception as e:
            status, detail = FAIL, f"{type(e).__name__}: {e}"[:400]
        self.record("avid_cma_init", status, detail)

    def null_text(self):
        path = _find(*[os.path.join(self.args.root, "pretrained",
                                    "openai-clip-l_null_text_encoding" + ext)
                       for ext in (".pt", ".npy")])
        if path is None:
            self.record("null_text_encoding", MISS, "not staged")
            return
        try:
            import numpy as np
            enc = (torch.from_numpy(np.load(path)) if path.endswith(".npy")
                   else torch.load(path, map_location="cpu",
                                   weights_only=True))
            ok = (tuple(enc.shape) == (1, 77, 768)
                  and bool(torch.isfinite(enc.float()).all()))
            status, detail = (PASS if ok else FAIL), \
                f"shape={tuple(enc.shape)} dtype={enc.dtype}"
        except Exception as e:
            status, detail = FAIL, f"{type(e).__name__}: {e}"[:400]
        self.record("null_text_encoding", status, detail)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=None,
                   help="artifact root (holds pretrained/, checkpoints/); "
                        "default the current directory, or with "
                        "--fabricate a temporary one")
    p.add_argument("--checkpoint_modules_dir", default=None,
                   help=".../checkpoint-N/modules of a trained AVSyncD "
                        "checkpoint")
    p.add_argument("--avsync_modules_dir", default=None,
                   help=".../checkpoint-40000/modules of the AVSync "
                        "classifier")
    p.add_argument("--avid_cma_path", default=None)
    p.add_argument("--fabricate", action="store_true",
                   help="write the inventory (tiny unless --full) and run "
                        "the gate over it")
    p.add_argument("--full", action="store_true",
                   help="with --fabricate: the published sizes (about 14 GB)")
    p.add_argument("--device", default="cuda",
                   help="where the modules are built (cpu for a machine "
                        "without a card)")
    p.add_argument("--run_tests", action="store_true",
                   help="finish with the port's loader parity tests "
                        "(needs JAX)")
    return p


def run(argv=None) -> Tuple[int, List[dict]]:
    """(exit code, [{label, status, detail, ...}]) of the gate."""
    args = parser().parse_args(argv)
    tmp = None
    if args.fabricate:
        from .fabricate import fabricate
        if args.root is None:
            tmp = args.root = tempfile.mkdtemp(prefix="validate_weights_")
        tree = fabricate(args.root, args.full, device=args.device)
        print(f"fabricated {sum(tree['bytes'].values())} bytes in "
              f"{tree['seconds']:.1f} s under {args.root}", flush=True)
        args.checkpoint_modules_dir = tree["checkpoint_modules_dir"]
        args.avsync_modules_dir = tree["avsync_modules_dir"]
        args.avid_cma_path = tree["avid_cma_path"]
    args.root = args.root or "."
    try:
        print(f"validating artifacts under {args.root} on {args.device}",
              flush=True)
        results = Gate(args, full=args.full or not args.fabricate).run_all()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if args.run_tests:
        rc = subprocess.call([sys.executable, "-m", "pytest", "-q",
                              *PARITY_TESTS], cwd=REPO)
        results.append(dict(label="parity_tests",
                            status=PASS if rc == 0 else FAIL,
                            detail=" ".join(PARITY_TESTS)))
        print(f"  [{results[-1]['status']:^10s}] parity_tests")
    return summary(results), results


def summary(results: List[dict]) -> int:
    """Print the tally of `results`; the exit code: 1 if a check failed."""
    n_fail = sum(r["status"] == FAIL for r in results)
    n_miss = sum(r["status"] == MISS for r in results)
    print(f"\n{len(results)} checks: {len(results) - n_fail - n_miss} pass, "
          f"{n_fail} fail, {n_miss} not staged", flush=True)
    return 1 if n_fail else 0


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
