"""Offline binarizer: raw corpus metadata -> feature record shards
(counterpart of `bisinger_tpu/data/binarizer.py:1-633`: `M4SingerBinarizer`,
alias `SingingBinarizer`, `TextGridBinarizer`, alias `ZhBinarizer`, and
`MidiSingingBinarizer`).

  - metadata: the BiSinger `raw_json_fn` line-per-dict format: {item_name,
    txt, phs, ph_dur, notes, notes_dur, is_slur, word_boundary, lang,
    speechsing}; for `MidiSingingBinarizer` (DiffSinger's PopCS), a JSON
    list of such items with their `wav_fn` in `<dir>/meta.json` for each
    dir of `processed_data_dir` (else `raw_data_dir`; a comma-separated
    list prefixes names and speakers with `ds<i>_`), the speaker "pop-cs"
    unless an item names one; for `TextGridBinarizer` (an MFA-aligned
    speech corpus), `raw_json_fn` lines of {item_name, wav_fn, tg_fn, txt,
    ph, spk, lang} without MIDI fields;
  - features per utterance: log-mel (`utils.audio.wav2spec`), f0 + coarse
    pitch, and mel2ph from the cumulative rounding of `ph_dur`, or from the
    TextGrid's last tier (`data/textgrid.py`; with
    `binarization_args.fix_zh_dur`, Chinese duration fixing for pinyin
    items of lang 1); with `binarization_args.with_f0cwt`, the CWT of the
    continuous log-f0 (`utils/cwt.py`) and its mean and std;
  - split: test items by `test_prefixes` (a name's start; for
    `MidiSingingBinarizer`, anywhere in it), else the tail; valid == test;
  - output per split: `<prefix>.data/.idx` shards (`data/records.py`),
    `<prefix>_lengths.npy`, `<prefix>_f0s_mean_std.npy`, plus
    `phone_set.json` and `spk_map.json`.

f0: `pitch_extractor: parselmouth` (the flagship's) uses parselmouth when
it imports and otherwise, with a warning, the in-repo Praat AC tracker
(`utils/praat_pitch.py`); `autocorr` is the quick numpy tracker. Before the
features, `binarization_args.trim_long_sil` collapses long silences (not
for TextGrid items, whose alignment is of the untrimmed audio) and
`loud_norm` scales the audio to -22 LUFS (`utils/audio.py`);
`binarization_args.with_spk_embed` adds a 256-d speaker vector
(`extract_spk_embed`: the JAX package's mel-statistics stand-in for
resemblyzer, which the port does not import; with the same warning).
`N_PROC` worker processes (default 1; one spawned pool for all the splits)
extract the items.
"""

from __future__ import annotations

import ast
import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from bisinger_tpu_torch.data.records import RecordWriter
from bisinger_tpu_torch.data.textgrid import (
    fix_zh_durations,
    is_sil_phoneme,
    textgrid_to_mel2ph,
)
from bisinger_tpu_torch.utils.audio import loudness_normalize, trim_long_silences, wav2spec
from bisinger_tpu_torch.utils.cwt import f0_to_cwt_spec, get_cont_lf0
from bisinger_tpu_torch.utils.pitch import f0_to_coarse_np
from bisinger_tpu_torch.utils.text_encoder import TokenTextEncoder

class BinarizationError(Exception):
    pass


def _align_f0(f0: np.ndarray, n_frames: int, hop: int) -> np.ndarray:
    """A Praat track aligned to the mel frames (reference
    `data_gen_utils.py:152-186`: a hop-dependent left pad, then the last
    value repeated)."""
    lpad = (4 if hop == 128 else 2) * 2
    rpad = n_frames - len(f0) - lpad
    f0 = np.pad(f0, (lpad, max(rpad, 0)))
    delta = n_frames - len(f0)
    if delta > 0:
        f0 = np.concatenate([f0, [f0[-1]] * delta])
    return f0[:n_frames].astype(np.float32)


def extract_f0_parselmouth(wav: np.ndarray, n_frames: int, hp) -> np.ndarray:
    """Praat's AC through parselmouth: f0_min 80, f0_max 750, voicing 0.6."""
    import parselmouth

    hop, sr = hp["hop_size"], hp["audio_sample_rate"]
    f0 = parselmouth.Sound(wav, sr).to_pitch_ac(
        time_step=hop / sr, voicing_threshold=0.6, pitch_floor=80,
        pitch_ceiling=750).selected_array["frequency"]
    return _align_f0(f0, n_frames, hop)


def extract_f0_praat_ac(wav: np.ndarray, n_frames: int, hp) -> np.ndarray:
    """The in-repo Praat AC tracker, same parameters and alignment as
    `extract_f0_parselmouth`."""
    from bisinger_tpu_torch.utils.praat_pitch import praat_pitch_ac

    hop, sr = hp["hop_size"], hp["audio_sample_rate"]
    f0 = praat_pitch_ac(wav, sr, time_step=hop / sr, voicing_threshold=0.6,
                        pitch_floor=80.0, pitch_ceiling=750.0)
    return _align_f0(f0, n_frames, hop)


def extract_f0_autocorr(wav: np.ndarray, n_frames: int, hp) -> np.ndarray:
    """Quick numpy tracker: windowed normalized autocorrelation peak within
    [80, 750] Hz, energy-gated voicing (`pitch_extractor: autocorr`)."""
    hop, sr = hp["hop_size"], hp["audio_sample_rate"]
    win = 1024
    lag_min, lag_max = int(sr / 750.0), int(sr / 80.0)
    pad = win // 2
    x = np.pad(wav.astype(np.float64), (pad, pad + win))
    f0 = np.zeros(n_frames, dtype=np.float32)
    rms_all = np.sqrt(np.mean(wav ** 2) + 1e-12)
    for i in range(n_frames):
        frame = x[i * hop: i * hop + win]
        frame = frame - frame.mean()
        rms = np.sqrt(np.mean(frame ** 2) + 1e-12)
        if rms < 0.1 * rms_all:
            continue
        spec = np.fft.rfft(frame, n=2 * win)
        ac = np.fft.irfft(spec * np.conj(spec))[:lag_max + 1]
        if ac[0] <= 0:
            continue
        ac = ac / ac[0]
        lag = int(np.argmax(ac[lag_min:lag_max + 1])) + lag_min
        if ac[lag] > 0.3:
            f0[i] = sr / lag
    return f0


_FALLBACK_WARNED: set = set()


def _warn_fallback(key: str, msg: str):
    if key not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add(key)
        print(f"| WARNING: {msg}", flush=True)


def extract_spk_embed(wav: np.ndarray, sample_rate: int, mel: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """A 256-d unit speaker vector from mel statistics
    (`bisinger_tpu/data/binarizer.py:144-200`, the branch without
    resemblyzer): the linear mel's per-bin mean and std and four moments
    (the spectral centroid's mean and std, the mel's mean and std), each
    block scaled to unit norm, concatenated, cut or padded to 256. `mel` is
    the item's log10 mel, else computed from the wav."""
    _warn_fallback(
        "spk_embed",
        "resemblyzer not installed — speaker embeddings fall back to "
        "mel-statistics vectors (discriminative but NOT a trained "
        "voice encoder; cross-corpus speaker similarity will be "
        "poor)",
    )
    if mel is None:
        mel = wav2spec(wav, sample_rate=sample_rate, fft_size=512, hop_size=128, win_size=512,
                       num_mels=80, fmin=30, fmax=sample_rate // 2, eps=1e-6)[1]
    lin = np.power(10.0, mel)
    centroid = (lin * np.arange(lin.shape[1])[None, :]).sum(1) / np.maximum(lin.sum(1), 1e-8)
    extra = np.array([centroid.mean(), centroid.std(), lin.mean(), lin.std()], np.float32)

    def unit(v):
        return v / max(np.linalg.norm(v), 1e-8)

    emb = np.concatenate([unit(lin.mean(0)), unit(lin.std(0)), unit(extra)])[:256].astype(
        np.float32)
    if len(emb) < 256:
        emb = np.pad(emb, (0, 256 - len(emb)))
    return emb / max(np.linalg.norm(emb), 1e-6)


def extract_f0(wav: np.ndarray, n_frames: int, hp) -> np.ndarray:
    extractor = hp.get("pitch_extractor", "parselmouth")
    if extractor == "autocorr":
        return extract_f0_autocorr(wav, n_frames, hp)
    if extractor == "parselmouth":
        try:
            return extract_f0_parselmouth(wav, n_frames, hp)
        except ImportError:
            _warn_fallback(
                "f0",
                "parselmouth not installed — using the built-in Praat-AC "
                "tracker (same Boersma-1993 algorithm and parameters, own "
                "implementation; contours are algorithm-equivalent but not "
                "bit-identical to Praat)",
            )
    return extract_f0_praat_ac(wav, n_frames, hp)


def derive_word_boundary(phs: List[str]) -> List[int]:
    """1 on every pinyin final or silence phone, for metas without an
    explicit word_boundary (reference `train_m4singer/binarize.py:203`)."""
    from bisinger_tpu_torch.data.text.pinyin import FINALS

    sil = {"AP", "SP", "<SIL>", "<AP>", "<SP>"}
    return [1 if p in FINALS or p in sil else 0 for p in phs]


def ph_durs_to_mel2ph(ph_durs: List[float], n_frames: int, hop_size: int,
                      sample_rate: int) -> np.ndarray:
    """Seconds per phone -> frame->phone map with cumulative rounding
    (reference `MidiSingingBinarizer.get_align`, `binarize.py:230-253`)."""
    mel2ph = np.zeros(n_frames, dtype=np.int64)
    start_time = 0.0
    for i, d in enumerate(ph_durs):
        start_frame = int(start_time * sample_rate / hop_size + 0.5)
        end_frame = int((start_time + d) * sample_rate / hop_size + 0.5)
        mel2ph[start_frame:end_frame] = i + 1
        start_time += d
    return mel2ph


def load_wav(path: str, sample_rate: int) -> np.ndarray:
    from scipy.io import wavfile

    sr, wav = wavfile.read(path)
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    elif wav.dtype != np.float32:
        wav = wav.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if sr != sample_rate:
        n_out = int(round(len(wav) * sample_rate / sr))
        wav = np.interp(np.linspace(0, len(wav) - 1, n_out), np.arange(len(wav)),
                        wav).astype(np.float32)
    return wav


class M4SingerBinarizer:
    """BiSinger binarizer over the `raw_json_fn` metadata format."""

    def __init__(self, hp):
        self.hp = hp
        self.items: Dict[str, Dict[str, Any]] = {}
        self.item_names: List[str] = []

    # ---- metadata --------------------------------------------------------
    def load_meta_data(self):
        hp = self.hp
        path = os.path.join(hp["raw_data_dir"], hp["raw_json_fn"])
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    song = json.loads(line)
                except json.JSONDecodeError:
                    song = ast.literal_eval(line)
                name = song["item_name"]
                wav_fn = song.get("wav_fn")
                if wav_fn is None:
                    singer_, song_name, sent_id = name.split("#")
                    wav_fn = f"{hp['raw_data_dir']}/{singer_}#{song_name}/{sent_id}.wav"
                # monolingual M4Singer metas carry no lang: Chinese (1)
                lang = song.get("lang", 1)
                wdb = song.get("word_boundary")
                self.items[name] = {
                    "item_name": name,
                    "wav_fn": wav_fn,
                    "txt": song["txt"],
                    "ph": " ".join(song["phs"]),
                    "ph_durs": song["ph_dur"],
                    "pitch_midi": song["notes"],
                    "midi_dur": song["notes_dur"],
                    "is_slur": song["is_slur"],
                    "word_boundary": derive_word_boundary(song["phs"]) if wdb is None else wdb,
                    "lang": lang if isinstance(lang, list) else [lang] * len(song["phs"]),
                    "speechsing": [song.get("speechsing", 1)],
                    "spk": name.split("#")[0],
                }
        self.item_names = sorted(self.items.keys())

    @staticmethod
    def _is_test_item(name: str, prefixes) -> bool:
        return any(name.startswith(p) for p in prefixes)

    def split_train_test(self) -> Tuple[List[str], List[str]]:
        prefixes = self.hp["test_prefixes"]
        test = [n for n in self.item_names if self._is_test_item(n, prefixes)]
        if prefixes and not test and self.item_names:
            raise ValueError(
                f"test_prefixes {list(prefixes)!r} match no items "
                f"(first items: {self.item_names[:3]}); fix the prefixes "
                "or clear them to use the tail-holdout split")
        if not test and self.item_names:
            n_test = max(1, min(self.hp.get("test_num", 100), len(self.item_names) // 5))
            test = self.item_names[-n_test:]
        test_set = set(test)
        return [n for n in self.item_names if n not in test_set], test

    # ---- vocab -----------------------------------------------------------
    def build_phone_encoder(self) -> TokenTextEncoder:
        hp = self.hp
        out = os.path.join(hp["binary_data_dir"], "phone_set.json")
        os.makedirs(hp["binary_data_dir"], exist_ok=True)
        if not os.path.exists(out) or hp.get("reset_phone_dict", True):
            phones = sorted({p for item in self.items.values() for p in item["ph"].split()})
            with open(out, "w") as f:
                json.dump(phones, f, ensure_ascii=False)
        with open(out) as f:
            phones = json.load(f)
        return TokenTextEncoder(vocab_list=phones, replace_oov=",")

    def build_spk_map(self) -> Dict[str, int]:
        spks = sorted({item["spk"] for item in self.items.values()})
        spk_map = {s: i for i, s in enumerate(spks)}
        if len(spk_map) > self.hp["num_spk"]:
            raise ValueError(f"{len(spk_map)} speakers in the corpus, num_spk is "
                             f"{self.hp['num_spk']}")
        with open(os.path.join(self.hp["binary_data_dir"], "spk_map.json"), "w") as f:
            json.dump(spk_map, f, ensure_ascii=False)
        return spk_map

    # ---- per item --------------------------------------------------------
    def process_item(self, item: Dict[str, Any], encoder: TokenTextEncoder,
                     spk_map: Dict[str, int]) -> Optional[Dict[str, Any]]:
        hp = self.hp
        try:
            wav = load_wav(item["wav_fn"], hp["audio_sample_rate"])
            if hp["binarization_args"].get("trim_long_sil") and "tg_fn" not in item:
                wav, _ = trim_long_silences(wav, hp["audio_sample_rate"])
            if hp.get("loud_norm"):
                wav = loudness_normalize(wav, hp["audio_sample_rate"])
            wav, mel = wav2spec(
                wav, sample_rate=hp["audio_sample_rate"], fft_size=hp["fft_size"],
                hop_size=hp["hop_size"], win_size=hp["win_size"],
                num_mels=hp["audio_num_mel_bins"], fmin=hp["fmin"], fmax=hp["fmax"],
                eps=float(hp.get("wav2spec_eps", 1e-6)))
            n_frames = mel.shape[0]
            res = {
                "item_name": item["item_name"],
                "txt": item["txt"],
                "ph": item["ph"],
                "mel": mel.astype(np.float32),
                "sec": len(wav) / hp["audio_sample_rate"],
                "len": n_frames,
                "spk_id": spk_map[item["spk"]],
            }
            if hp["binarization_args"].get("with_wav"):
                res["wav"] = wav.astype(np.float32)
            if hp["binarization_args"].get("with_spk_embed"):
                res["spk_embed"] = extract_spk_embed(wav, hp["audio_sample_rate"], mel=mel)
            if hp["binarization_args"].get("with_f0", True):
                f0 = extract_f0(wav, n_frames, hp)
                if f0.sum() == 0:
                    raise BinarizationError("Empty f0")
                res["f0"] = f0
                res["pitch"] = f0_to_coarse_np(f0)
            if hp["binarization_args"].get("with_f0cwt") and "f0" in res:
                # the continuous log-f0's statistics and its CWT
                # (`binarizer.py:439-451`)
                _, cont_lf0 = get_cont_lf0(res["f0"])
                lf0_mean, lf0_std = float(np.mean(cont_lf0)), float(np.std(cont_lf0))
                cwt_spec, _, _ = f0_to_cwt_spec(res["f0"], lf0_mean, lf0_std)
                if np.any(np.isnan(cwt_spec)):
                    raise BinarizationError("NaN CWT")
                res["cwt_spec"] = cwt_spec
                res["cwt_mean"] = lf0_mean
                res["cwt_std"] = lf0_std
            phone = encoder.encode(item["ph"])
            if len(phone) == 0:
                raise BinarizationError("Empty phoneme")
            res["phone"] = np.asarray(phone, dtype=np.int64)
            res["ph_is_sil"] = np.asarray(
                [int(is_sil_phoneme(p)) for p in item["ph"].split()], dtype=np.int64)
            res["mel2ph"] = self.get_align(item, n_frames, f0=res.get("f0"))
            if "pitch_midi" in item:
                for key in ("pitch_midi", "is_slur", "word_boundary", "lang"):
                    res[key] = np.asarray(item[key], dtype=np.int64)
                res["midi_dur"] = np.asarray(item["midi_dur"], dtype=np.float32)
                res["speechsing"] = np.asarray(item["speechsing"], dtype=np.int64)
                if not (res["pitch_midi"].shape == res["is_slur"].shape == res["lang"].shape
                        == (len(phone),)):
                    raise ValueError(f"{item['item_name']}: notes {res['pitch_midi'].shape}, "
                                     f"slurs {res['is_slur'].shape}, lang {res['lang'].shape} "
                                     f"against {len(phone)} phones")
            return res
        except BinarizationError as e:
            print(f"| Skip item ({e}). item_name: {item['item_name']}")
            return None

    def get_align(self, item: Dict[str, Any], n_frames: int, f0=None) -> np.ndarray:
        """mel2ph from the per-phone durations (`binarizer.py:482-487`)."""
        return ph_durs_to_mel2ph(item["ph_durs"], n_frames, self.hp["hop_size"],
                                 self.hp["audio_sample_rate"])

    # ---- the whole corpus ------------------------------------------------
    def process(self):
        hp = self.hp
        self.load_meta_data()
        os.makedirs(hp["binary_data_dir"], exist_ok=True)
        encoder = self.build_phone_encoder()
        spk_map = self.build_spk_map()
        train, test = self.split_train_test()
        n_proc = int(os.environ.get("N_PROC", 1))
        pool = (ProcessPoolExecutor(n_proc, mp_context=mp.get_context("spawn"))
                if n_proc > 1 else None)
        try:
            for prefix, names in [("valid", test), ("test", test), ("train", train)]:
                self.process_split(prefix, names, encoder, spk_map, pool)
        finally:
            if pool is not None:
                pool.shutdown()

    def process_split(self, prefix, names, encoder, spk_map, pool=None):
        hp = self.hp
        items = [self.items[name] for name in names]
        if pool is not None:
            results = list(pool.map(self.process_item, items, [encoder] * len(items),
                                    [spk_map] * len(items)))
        else:
            results = [self.process_item(item, encoder, spk_map) for item in items]
        lengths, f0s = [], []
        with RecordWriter(os.path.join(hp["binary_data_dir"], prefix)) as writer:
            for res in results:
                if res is None:
                    continue
                writer.add_item(res)
                lengths.append(res["len"])
                if "f0" in res:
                    f0s.append(res["f0"])
        np.save(os.path.join(hp["binary_data_dir"], f"{prefix}_lengths.npy"),
                np.asarray(lengths, dtype=np.int64))
        if f0s:
            cat = np.concatenate(f0s)
            voiced = cat[cat > 0]
            np.save(os.path.join(hp["binary_data_dir"], f"{prefix}_f0s_mean_std.npy"),
                    np.asarray([voiced.mean(), voiced.std()], dtype=np.float32))
        print(f"| binarized {prefix}: {len(lengths)} items")


class MidiSingingBinarizer(M4SingerBinarizer):
    """PopCS-style MIDI singing metadata (`binarizer.py:579-628`)."""

    def load_meta_data(self):
        root = str(self.hp.get("processed_data_dir") or self.hp["raw_data_dir"])
        multi = "," in root
        for ds_id, data_dir in enumerate(root.split(",")):
            with open(os.path.join(data_dir, "meta.json"), encoding="utf-8") as f:
                songs = json.load(f)
            for song in songs:
                name, spk = song["item_name"], song.get("spk", "pop-cs")
                if multi:
                    name, spk = f"ds{ds_id}_{name}", f"ds{ds_id}_{spk}"
                lang = song.get("lang", 1)
                self.items[name] = {
                    "item_name": name,
                    "wav_fn": song["wav_fn"],
                    "txt": song["txt"],
                    "ph": " ".join(song["phs"]),
                    "ph_durs": song["ph_dur"],
                    "pitch_midi": song["notes"],
                    "midi_dur": song["notes_dur"],
                    "is_slur": song["is_slur"],
                    "word_boundary": song.get("word_boundary")
                    or derive_word_boundary(song["phs"]),
                    "lang": lang if isinstance(lang, list) else [lang] * len(song["phs"]),
                    "speechsing": [song.get("speechsing", 1)],
                    "spk": spk,
                }
        self.item_names = sorted(self.items.keys())

    @staticmethod
    def _is_test_item(name: str, prefixes) -> bool:
        return any(p in name for p in prefixes)


class TextGridBinarizer(M4SingerBinarizer):
    """An MFA-aligned corpus (`binarizer.py:534-578`): each meta item names
    its TextGrid (`tg_fn`) in place of per-phone durations, and mel2ph comes
    from the alignment's last tier."""

    def load_meta_data(self):
        hp = self.hp
        path = os.path.join(hp["raw_data_dir"], hp["raw_json_fn"])
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                song = json.loads(line)
                name = song["item_name"]
                self.items[name] = {
                    "item_name": name,
                    "wav_fn": song["wav_fn"],
                    "tg_fn": song["tg_fn"],
                    "txt": song["txt"],
                    "ph": song["ph"] if isinstance(song["ph"], str) else " ".join(song["ph"]),
                    "spk": song.get("spk", name.split("#")[0]),
                    "lang": song.get("lang", 1),
                }
        self.item_names = sorted(self.items.keys())

    def get_align(self, item: Dict[str, Any], n_frames: int, f0=None) -> np.ndarray:
        with open(item["tg_fn"], encoding="utf-8") as f:
            tg_text = f.read()
        mel2ph, _ = textgrid_to_mel2ph(tg_text, item["ph"], n_frames, self.hp["hop_size"],
                                       self.hp["audio_sample_rate"])
        if self.hp["binarization_args"].get("fix_zh_dur") and item.get("lang", 1) == 1:
            # pinyin-phone Chinese items only (see fix_zh_durations)
            mel2ph = fix_zh_durations(mel2ph, item["ph"].split(" "), f0=f0)
        return mel2ph


# the reference's names of the BiSinger and the TextGrid binarizers
SingingBinarizer = M4SingerBinarizer
ZhBinarizer = TextGridBinarizer
# the classes `binarizer_cls` names, by the last part of a dotted name; the
# reference's ZhSingingBinarizer is ZhBinarizer (`bisinger_tpu/run.py:54-63`)
BINARIZERS = {c.__name__: c for c in (M4SingerBinarizer, MidiSingingBinarizer,
                                      TextGridBinarizer)}
BINARIZERS.update(SingingBinarizer=SingingBinarizer, ZhBinarizer=ZhBinarizer,
                  ZhSingingBinarizer=ZhBinarizer)


def binarizer_class(name: str):
    """`binarizer_cls` (empty for the BiSinger binarizer) -> the port's class."""
    short = (name or "M4SingerBinarizer").rsplit(".", 1)[-1]
    if short not in BINARIZERS:
        raise NotImplementedError(f"binarizer_cls={name!r} is not ported (the port has "
                                  f"{', '.join(sorted(BINARIZERS))})")
    return BINARIZERS[short]
