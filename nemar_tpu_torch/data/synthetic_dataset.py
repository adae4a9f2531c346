"""Synthetic misaligned multimodal pairs — no files needed.

Not in the reference (its commercial dataset was never released — SURVEY.md
§3.1 'NeMAR dataset'); this generator fills that gap so the framework is
runnable end-to-end out of the box: smoke tests, benchmarks, and sanity
training runs where registration is actually learnable.

Each index deterministically produces:
  * a smooth random 'scene' (low-frequency noise),
  * modality A: one appearance mapping of the scene, geometrically
    MISALIGNED by a random small affine transform,
  * modality B: a different appearance mapping (inverted + channel-coded),
    at the reference geometry.

A registration model should learn to undo the misalignment; a translation
model should learn the appearance mapping.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from nemar_tpu_torch.data.base_dataset import BaseDataset


class SyntheticDataset(BaseDataset):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument("--synthetic_size", type=int, default=64,
                            help="number of synthetic pairs per epoch")
        parser.add_argument("--synthetic_misalign", type=float, default=0.05,
                            help="max affine misalignment (fraction of image size)")
        parser.add_argument("--synthetic_same_appearance", action="store_true",
                            help="A and B share the appearance mapping (pure "
                                 "registration task; isolates the STN)")
        parser.add_argument("--synthetic_appearance", type=str, default="bands",
                            choices=["bands", "smooth"],
                            help="B's appearance mapping [bands | smooth]. "
                                 "'bands' (legacy) uses sin^2 value bands — "
                                 "spatially oscillatory, which wrecks the "
                                 "photometric flow landscape (oracle-G fit "
                                 "stalls at ~2 px); 'smooth' uses distinct "
                                 "monotone per-channel remaps (IR<->RGB-"
                                 "like), structure-preserving and "
                                 "registrable.")
        parser.add_argument("--synthetic_pad_crop", action="store_true",
                            help="render on a padded canvas and center-crop, "
                                 "so A has NO zero-fill borders: border "
                                 "widths otherwise leak the misalignment to "
                                 "the generator, which then aligns from the "
                                 "border cue and the joint optimum drives "
                                 "the STN's field to zero (round-2 science); "
                                 "real multimodal data has no such cue. The "
                                 "center crop preserves the center-origin GT "
                                 "affine exactly.")
        parser.add_argument("--synthetic_fresh_affine", action="store_true",
                            help="draw a FRESH random misalignment on every "
                                 "access of an item (epoch-wise geometric "
                                 "augmentation). Round-3 science: a global "
                                 "6-param regressor generalizes only with "
                                 "enough distinct misalignments (held-out "
                                 "EPE 2.1 px @192 fixed pairs -> 0.5 px "
                                 "with fresh affines); also removes the "
                                 "phi=0 + memorizing-G joint optimum.")
        parser.set_defaults(dataroot="__synthetic__", preprocess="none",
                            load_size=256)
        return parser

    def __init__(self, opt):
        super().__init__(opt)
        self.size = getattr(opt, "synthetic_size", 64)
        self.res = opt.crop_size
        self.misalign = getattr(opt, "synthetic_misalign", 0.05)
        self.same_appearance = getattr(opt, "synthetic_same_appearance", False)
        self.pad_crop = getattr(opt, "synthetic_pad_crop", False)
        self.appearance = getattr(opt, "synthetic_appearance", "bands")
        self.input_nc = opt.input_nc
        self.output_nc = opt.output_nc
        self.seed = getattr(opt, "seed", 0)
        self.fresh_affine = getattr(opt, "synthetic_fresh_affine", False)
        # per-item access counters for --synthetic_fresh_affine: each visit
        # of an index re-draws the misalignment (scene + appearance stay
        # index-deterministic). Worker processes each carry their own
        # counters — the draws stay random across epochs either way, which
        # is the point; eval datasets should not set the flag.
        self._visits = {}

    def __len__(self):
        return self.size

    def _scene(self, rng: np.random.Generator, res: int) -> np.ndarray:
        """Multi-octave random field in [0, 1] at full resolution.

        The high-frequency octaves matter: with smooth-only content a few
        pixels of misalignment are photometrically invisible, the STN gets
        no gradient and the registration task degenerates (the generator
        absorbs the geometry instead).
        """
        field = np.zeros((res, res), np.float32)
        for scale, weight in ((16, 0.5), (6, 0.3), (3, 0.2)):
            size = max(2, res // scale)
            octave = rng.standard_normal((size, size)).astype(np.float32)
            img = Image.fromarray(octave, mode="F").resize(
                (res, res), Image.BICUBIC
            )
            field += weight * np.asarray(img, dtype=np.float32)
        lo, hi = field.min(), field.max()
        return (field - lo) / max(hi - lo, 1e-6)

    def __getitem__(self, index):
        rng = np.random.default_rng(self.seed * 100003 + index)
        # pad_crop: render on a larger canvas and center-crop so the affine
        # pulls REAL content (not zero fill) into view — no border cue.
        pad = (
            int(np.ceil(self.misalign * self.res * 2.5)) if self.pad_crop else 0
        )
        res_p = self.res + 2 * pad
        scene = self._scene(rng, res_p)

        # modality B: appearance mapping at reference geometry
        b_scene = scene[pad:pad + self.res, pad:pad + self.res] if pad else scene
        b = self._colorize(b_scene, self.output_nc, invert=True,
                           style=self.appearance)

        # modality A: different appearance, misaligned by a random affine
        if self.fresh_affine:
            visit = self._visits[index] = self._visits.get(index, 0) + 1
            rng = np.random.default_rng(
                (self.seed * 100003 + index) * 1009 + visit
            )
        m = self.misalign * self.res
        angle = rng.uniform(-self.misalign, self.misalign)  # radians
        tx, ty = rng.uniform(-m, m, size=2)
        ca, sa = np.cos(angle), np.sin(angle)
        c = res_p / 2.0
        # PIL affine takes the INVERSE map (output->input) coefficients.
        a_img = Image.fromarray((scene * 255).astype(np.uint8)).transform(
            (res_p, res_p), Image.AFFINE,
            (ca, -sa, c - ca * c + sa * c + tx, sa, ca, c - sa * c - ca * c + ty),
            resample=Image.BILINEAR, fillcolor=0,
        )
        a_scene = np.asarray(a_img, dtype=np.float32) / 255.0
        if pad:
            # center crop about the SAME center the affine was applied at:
            # the center-origin GT map below is exact for the crop too.
            a_scene = a_scene[pad:pad + self.res, pad:pad + self.res]
        a = self._colorize(a_scene, self.input_nc, invert=self.same_appearance,
                           style=self.appearance)

        # center-origin inverse map M (output px -> source px) that rendered
        # A — the ground truth for registration evaluation (utils.metrics).
        theta_m = np.asarray(
            [[ca, -sa, tx], [sa, ca, ty]], dtype=np.float32
        )
        return {
            "A": a * 2.0 - 1.0,
            "B": b * 2.0 - 1.0,
            "theta_gt": theta_m,
            "A_paths": f"synthetic_{index:05d}_A.png",
            "B_paths": f"synthetic_{index:05d}_B.png",
        }

    @staticmethod
    def _colorize(scene: np.ndarray, nc: int, invert: bool,
                  style: str = "bands") -> np.ndarray:
        s = 1.0 - scene if invert else scene
        if nc == 1:
            return s[:, :, None]
        if style == "smooth":
            # distinct MONOTONE per-channel remaps: multimodal appearance
            # that preserves spatial structure (real IR<->RGB is close to a
            # smooth intensity remap). The sin^2 bands below oscillate in
            # value => oscillate in SPACE over the scene field, which
            # destroys the photometric basin the flow needs (oracle-G fit:
            # 1.9 px bands vs 0.3 px linear; round-2 science).
            chans = [s, np.square(s), np.sqrt(np.clip(s, 0.0, 1.0))]
            while len(chans) < nc:
                chans.append(s)
            return np.stack(chans[:nc], axis=-1)
        chans = [s]
        for k in range(1, nc):
            chans.append(np.clip(np.sin(np.pi * s * (k + 1)) ** 2, 0, 1))
        return np.stack(chans[:nc], axis=-1)
