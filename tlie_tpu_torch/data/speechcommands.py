"""Speech Commands keyword spotting (the 10-word subset or all 35 words),
copied from ``tlie_tpu/data/speechcommands.py`` (numpy only).

The clips come from the first of these that exists:
  1. the Google Speech Commands v0.02 tree under ``data_dir``
     (``<word>/<file>.wav``; the files named in ``testing_list.txt`` and
     ``validation_list.txt`` form the test split), read with the standard
     library's ``wave`` (16-bit PCM; channels averaged) and cut or
     zero-padded to ``length`` samples;
  2. the synthetic harmonic-keyword generator (``synthetic: true``, or no
     tree: the loader prints ``tlie_tpu``'s line): class c has its own
     fundamental, harmonic signature and amplitude contour, plus noise,
     labels ``i % classes`` in order, drawn bit for bit as ``tlie_tpu``
     draws them from ``seed``.
Features: with ``mfcc`` the numpy MFCC (:func:`mfcc`: Hann window, n_fft
400, hop 100, 64 HTK mel bands, log, orthonormal DCT-II to 20
coefficients), 161 frames × 20 at 16 kHz; without it the waveform
standardised per clip, (length, 1).  With ``dropped_rate`` > 0 frames (or
samples) are zeroed at that rate and a mask channel is appended, drawn from
``seed + 1``.  ``d_input`` is 20 or 1, plus 1 with the mask; ``d_output``
10, or 35 with ``all_classes``; ``l_max`` 161 with ``mfcc``, else
``length``.  ``split(name)`` gives (inputs (n, l_max, d_input) float32,
labels (n,) int64).
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .base import SequenceDataset, argmax_accuracy

# the standard 10-word command subset (s4/lra convention)
SC10 = ("yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go")
SC35 = SC10 + (
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "bed", "bird", "cat", "dog", "happy", "house", "marvin", "sheila",
    "tree", "wow", "backward", "forward", "follow", "learn", "visual",
)


def read_wav(path) -> np.ndarray:
    """A 16-bit PCM wav as float32 in [-1, 1], channels averaged."""
    import wave

    with wave.open(str(path), "rb") as w:
        raw = w.readframes(w.getnframes())
        width = w.getsampwidth()
        channels = w.getnchannels()
    if width != 2:
        raise ValueError(f"{path}: only 16-bit PCM supported (width {width})")
    x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x


def fix_length(x: np.ndarray, length: int) -> np.ndarray:
    """``x`` cut to ``length`` samples, or zero-padded at the end to it."""
    if len(x) >= length:
        return x[:length]
    return np.pad(x, (0, length - len(x)))


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int, n_fft: int, sr: int) -> np.ndarray:
    """Triangular filters on the HTK mel scale, (n_mels, n_fft // 2 + 1)
    float32; built once for each setting (read-only)."""
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
    imel = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)  # noqa: E731
    pts = imel(np.linspace(mel(0.0), mel(sr / 2), n_mels + 2))
    bins = np.floor((n_fft + 1) * pts / sr).astype(np.int64)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for m in range(1, n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            if c > lo:
                fb[m - 1, k] = (k - lo) / (c - lo)
        for k in range(c, hi):
            if hi > c:
                fb[m - 1, k] = (hi - k) / (hi - c)
    fb.setflags(write=False)
    return fb


def mfcc(x: np.ndarray, sr: int = 16000, n_mfcc: int = 20, n_fft: int = 400, hop: int = 100,
         n_mels: int = 64) -> np.ndarray:
    """(L,) waveform → (frames, n_mfcc) float32 MFCC, the frames centred
    (reflect padding of n_fft // 2); 16,000 samples give 161 frames."""
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * np.hanning(n_fft)[None, :]
    power = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    melspec = power @ mel_filterbank(n_mels, n_fft, sr).T
    logmel = np.log(melspec + 1e-6)
    # orthonormal DCT-II over the mel axis
    k = np.arange(n_mels)
    basis = np.cos(np.pi / n_mels * (k[None, :] + 0.5) * np.arange(n_mfcc)[:, None])
    scale = np.full((n_mfcc, 1), np.sqrt(2.0 / n_mels))
    scale[0] = np.sqrt(1.0 / n_mels)
    return (logmel @ (basis * scale).T).astype(np.float32)


def synthetic_keyword(rng, cls: int, n_classes: int, length: int, sr: int = 16000) -> np.ndarray:
    """One clip of class ``cls``: three harmonics of its fundamental with
    its amplitude signature, its amplitude contour, and noise."""
    t = np.arange(length, dtype=np.float32) / sr
    f0 = 110.0 * (1.0 + cls * 0.35)  # well-separated fundamentals
    sig = np.zeros(length, np.float32)
    for h in range(1, 4):
        amp = 1.0 / h * (1.0 + 0.5 * np.sin(cls + h))  # class harmonic signature
        sig += amp * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    # class-dependent amplitude modulation (syllable rhythm)
    am = 0.55 + 0.45 * np.sin(2 * np.pi * (1.5 + 0.7 * (cls % 5)) * t)
    sig = sig * am.astype(np.float32)
    sig += rng.normal(0, 0.1, length).astype(np.float32)
    return sig


def read_sc_tree(data_dir, classes: Tuple[str, ...], length: int
                 ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(train clips, train labels, test clips, test labels) from the Speech
    Commands tree under ``data_dir``, each class's files in name order;
    None where no class folder is there or a split is empty."""
    data_dir = Path(data_dir)
    if not any((data_dir / c).is_dir() for c in classes):
        return None
    test_files = set()
    for lst in ("testing_list.txt", "validation_list.txt"):
        f = data_dir / lst
        if f.is_file():
            test_files.update(line.strip() for line in f.read_text().splitlines())
    tr_x: List[np.ndarray] = []
    tr_y: List[int] = []
    te_x: List[np.ndarray] = []
    te_y: List[int] = []
    for ci, cls in enumerate(classes):
        cdir = data_dir / cls
        if not cdir.is_dir():
            continue
        for wav in sorted(cdir.glob("*.wav")):
            x = fix_length(read_wav(wav), length)
            if f"{cls}/{wav.name}" in test_files:
                te_x.append(x)
                te_y.append(ci)
            else:
                tr_x.append(x)
                tr_y.append(ci)
    if not tr_x or not te_x:
        return None
    return (np.stack(tr_x), np.asarray(tr_y, np.int64),
            np.stack(te_x), np.asarray(te_y, np.int64))


class SpeechCommands(SequenceDataset):
    """The Speech Commands splits as
    ``tlie_tpu.data.speechcommands.SpeechCommands.setup`` builds them."""

    _name_ = "sc"
    # the knobs of ref dataloaders/basic.py:219-227
    init_defaults = {
        "mfcc": False,
        "dropped_rate": 0.0,
        "length": 16000,
        "all_classes": False,
        "seed": 42,
        "synthetic": False,
        "synthetic_train": 512,
        "synthetic_test": 128,
    }

    def __init__(self, _name_: str = "sc", data_dir=None, **cfg):
        super().__init__(_name_, data_dir, **cfg)
        self._built = False

    @property
    def d_input(self) -> int:
        return (20 if self.mfcc else 1) + (1 if self.dropped_rate > 0.0 else 0)

    @property
    def d_output(self) -> int:
        return 35 if self.all_classes else 10

    @property
    def l_max(self) -> int:
        return 161 if self.mfcc else self.length

    @staticmethod
    def get_metrics():
        return argmax_accuracy

    def split(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        if name not in ("train", "test"):
            raise ValueError(f"unknown split {name!r}")
        self.setup()
        return getattr(self, f"{name}_inputs"), getattr(self, f"{name}_labels")

    def setup(self) -> None:
        if not self._built:
            self._build()
            self._built = True

    def featurize(self, waves: np.ndarray, rng) -> np.ndarray:
        """(n, length) clips → (n, l_max, d_input) float32 features; the
        drop mask, where ``dropped_rate`` asks for one, at the feature rate
        (MFCC frames or samples), drawn from ``rng``."""
        if self.mfcc:
            feats = np.stack([mfcc(w) for w in waves])  # (N, 161, 20)
        else:
            mu = waves.mean(axis=1, keepdims=True)
            sd = waves.std(axis=1, keepdims=True) + 1e-6
            feats = ((waves - mu) / sd)[..., None]  # (N, L, 1)
        if self.dropped_rate > 0.0:
            mask = rng.random(feats.shape[:2]) < self.dropped_rate
            feats = feats.copy()
            feats[mask] = 0.0
            feats = np.concatenate([feats, mask[..., None].astype(np.float32)], axis=-1)
        return feats.astype(np.float32)

    def _build(self) -> None:
        classes = SC35 if self.all_classes else SC10
        loaded = None
        if self.data_dir and not self.synthetic:
            loaded = read_sc_tree(self.data_dir, classes, self.length)
        if loaded is None:
            if not self.synthetic:
                print(
                    f"SpeechCommands | no corpus under {self.data_dir!r}; "
                    "using the synthetic harmonic-keyword generator"
                )
            rng = np.random.default_rng(self.seed)
            nc = len(classes)
            tr_y = np.arange(self.synthetic_train, dtype=np.int64) % nc
            te_y = np.arange(self.synthetic_test, dtype=np.int64) % nc
            tr_x = np.stack([synthetic_keyword(rng, int(c), nc, self.length) for c in tr_y])
            te_x = np.stack([synthetic_keyword(rng, int(c), nc, self.length) for c in te_y])
        else:
            tr_x, tr_y, te_x, te_y = loaded

        rng = np.random.default_rng(self.seed + 1)
        self.train_inputs = self.featurize(tr_x, rng)
        self.train_labels = tr_y
        self.test_inputs = self.featurize(te_x, rng)
        self.test_labels = te_y
        print(
            f"SpeechCommands | {'mfcc' if self.mfcc else 'raw'} L={self.l_max} "
            f"classes={self.d_output} | train {len(tr_y)} test {len(te_y)}"
        )
