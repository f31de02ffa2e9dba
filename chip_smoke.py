"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root, with one card:

    python3 chip_smoke.py

Each kernel has two routes, chosen by the hyperparameter compute_dtype:
fp32 (csrc/diffnet_stack.cu, csrc/mrf_stage.cu: the TF32 tensor cores
in 3xTF32, fp32's accuracy) and bf16 on the tensor cores
(csrc/diffnet_stack_bf16.cu, csrc/mrf_stage_bf16.cu), the flagship's
default. Every check of a route against its plain version also reads a
control against the plain version: for fp32, the plain version with
single-pass TF32 products (ops/_tf32.py), at least 10x the kernel's
relative max; for bf16, the plain version with one rounding point moved,
above the mean bound. Phases, each printing one line with its results
and seconds (a failed phase exits non-zero):
  1. device: name, count, nvidia-smi's name and power limit;
  2. build the four kernels with nvcc at every width each is built for
     (csrc/*.cu, ops/_build.py WIDTHS: one library a kernel and width,
     one process a library): the widths phases 3-20 launch first
     (FIRST_WIDTHS), every nvcc started at once, the others in the
     background at a lower priority, as many at once as the host has
     cores, joined before phase 21;
  3. K1 (DiffNet residual stack), both routes, against their plain
     versions at the flagship widths, B=4, T=256;
  4. K2 (MRF stage), both routes, against their plain versions at each
     stage width, B=2;
  5. the flagship path in fp32 (compute_dtype float32): synthesize() on a
     4 x 64-token, 256-frame batch with mel2ph given, launch counts, and a
     small input against the same path on the CPU; then in bf16 (the
     default): the same batch and one request through the duration
     predictor, launch counts on the bf16 kernels only, no K1-bf16 weight
     pack (both calls take its narrow path), finite non-silent waveforms of
     frames x 128 samples, and the small input against the
     fp32 path on the card within the JAX package's bf16 contract;
  6. the four kernels against their plain versions at the timed shapes
     (B=4, T=256 and the bench's B=32, T=1024), with CUDA-event times of
     both, of the same work as a chain of library calls (fp32 with TF32
     off, and bf16: cuDNN conv1d and cuBLAS products for K1, conv1d for
     K2), and each kernel's bound (the fp32 routes' at 495 / 3 TFLOP/s,
     3xTF32 on the TF32 tensor cores, with the factor against the fp32
     CUDA cores' 67 TFLOP/s beside it); and (read after phase 9) the bf16
     kernels launched back to back, REPEAT_LAUNCHES + 1 times each case,
     in a child process started when the background build is joined, run
     beside phases 21 and 9 (which time nothing that is reported as a
     kernel's time) and killed REPEAT_TIMEOUT_S after its start
     (tools/repeat_launch.py CASES: K1-bf16 at B=32, T=1024 and B=4,
     T=256, K2-bf16's F=256 stage at both, and the layouts other widths
     add: K1-bf16 at C = 64 and 512, K2-bf16 at F = 8, 16 and 512), each
     last output bit for bit the first;
  7. warm synthesize() wall times at B=4, T=256 and at the bench's
     B=32, T=1024 under bf16 (and fp32 beside it), as audio seconds made
     per second, and K1-bf16's weights packed once over the 201 wide-path
     denoiser calls of the bf16 B=32 call;
  8. scores through the port's entry points in bf16, with the card's
     bucket overrides (CARD_BUCKETS): run.main --infer on three scores
     (pinyin, English, mixed), the HTTP server (max_batch 4, chunks of 16
     words) answering /health and four concurrent requests, one streamed
     and one of two chunks, then one request at a time; DDPM, DPM-Solver++
     and PLMS from the shallow start on one short request; each part's
     launch counts, and the two deterministic samplers in fp32 on the card
     against the CPU on a 32-frame input;
  10. (run before 9) the acoustic training path in bf16 at the flagship's
     widths and batch shape (B=48, 16 tokens, 512 frames): the synthetic
     corpus (64 items) binarized by `run --binarize`; the FFT-Singer and
     diffusion stages, 10 steps each, through run's trainer on the
     device-resident corpus, the diffusion stage's fs2 warm-started from
     diff_params.npz; `--validate` and a resume to step 12. Gates: finite
     losses and gradients, non-zero encoder and DiffNet gradients, no K1
     or K2 launch in any train step, a 0-step export equal to
     diff_params.npz, one fp32 step of each task on the card against the
     CPU; the trained weights served at B=4, T=512 through K1-bf16 and
     K2-bf16 (`launches_by_path["trained"]`). The record codec: every
     shard of the corpus read whole by the native reader
     (bisinger_tpu_torch/native, built at first use with the host C++
     compiler) and by the Python decoder, equal record for record, each
     backend's records/s on the card's host; both stages' datasets read
     natively (the codec's record counter above 0; phases 11-17's too,
     checked after 14). Steps/s (the first step apart), peak memory and
     the losses at steps 1 and 20 are reported; the trainer's log goes to
     checkpoints/chip_smoke/training.log;
  11. (run before 9) the rest of the flagship cascade trained in bf16 at
     full width, only the steps cut: the PitchExtractor through run's
     trainer on phase 10's corpus (hparams_diff.json with the keys of
     configs/tts/pe.yaml, B=48, 512 frames), 10 steps, `--validate`, a
     resume to 12; the NSF HiFi-GAN through tools/train_vocoder at the
     flagship recipe's setting (512 channels, B=8, 64 frames), 10 steps in
     full band and 20 in mb4 (PQMF, 4 subbands). Gates: finite losses, a
     non-zero gradient on every PE parameter, the PE's running statistics
     moved, no K1 or K2 launch in any train step, one fp32 step of the PE
     (from its initialisation and from the PE trained here) and one GAN
     step of each vocoder (voiced f0) on the card against the CPU
     (tools/step_parity; the PE's also read against its float64 step). The
     trained PE and full-band generator with diff_params.npz through
     SVSInferTorch.from_checkpoint at B=4, T=512 (K1-bf16 and K2-bf16,
     `launches_by_path["trained_cascade"]`); the mb4 generator on the same
     mel through K2 and PQMF in both routes (`launches_by_path["mb4"]`),
     bf16 against fp32 within the JAX package's bf16 contract. Steps/s,
     peak memory, f0 MAE (PE), gen_mel and disc_loss at steps 1 and 20
     (vocoder) are reported; the log goes to
     checkpoints/chip_smoke/cascade.log;
  12. (run before 9) DiffSinger's PopCS family from the repo's own YAML
     configs (configs/usr/popcs_*.yaml, read without PyYAML) in bf16 at the
     configs' widths and batching, only the steps cut: the synthetic corpus
     (64 items, fmt "popcs") binarized by `run --binarize` with
     MidiSingingBinarizer; popcs_fs2 (plain FastSpeech2, frame pitch with
     uv) 10 steps, `--validate`, a resume to 12; popcs_ds_beta6 (T=100,
     K=51) 10 steps warm-started from it; popcs_ds_beta6_offline 10 steps on
     the fs2 mels the phase writes; popcs_ds_beta6 served through
     `from_work_dir` with the flagship vocoder and no PE (f0 from the
     model), shallow PLMS at pndm_speedup 1: K1-bf16 52 launches (K/speedup
     + 1, as JAX's loop calls the denoiser), K2-bf16 4
     (`launches_by_path["popcs served"]`); one fp32 step of FastSpeech2Task
     (pitch, uv, energy) and of DiffSingerOfflineTask on the card against
     the CPU at phase 10's bounds, every loss. Steps/s, peak memory, the
     served request's seconds; the log goes to
     checkpoints/chip_smoke/popcs.log;
  13. (run before 9) DiffSpeech TTS from the repo's LJSpeech configs
     (configs/tts/lj/fs2.yaml, configs/usr/lj_ds_beta6.yaml,
     configs/tts/hifigan.yaml) in bf16 at their widths and batching, only
     the steps cut: a TextGrid corpus written here (64 items of 2-4 s at
     22.05 kHz, ARPAbet phones) binarized by `run --binarize` with the
     TextGrid binarizer (ZhBinarizer) and the CWT features; lj/fs2 (the CWT
     pitch head) 10 steps; lj_ds_beta6 (T=100, K=71) 10 steps warm-started
     from it, `--validate`; the plain HiFi-GAN (no NSF, rates 8·8·2·2, hop
     256, 512 channels) through tools/train_vocoder at B=8, 64 frames, 20
     steps; the DiffSpeech work dir served through `from_work_dir` with an
     assets dir holding the trained generator and its own config (16
     K1-bf16, 4 K2-bf16 launches), then through `run --infer` on the card;
     one fp32 step of the lj/fs2 task and of the plain GAN task on the card
     against the CPU. Steps/s, peak memory, losses (the CWT loss C among
     them), the served request's seconds; the log goes to
     checkpoints/chip_smoke/tts.log;
  14. (run before 9) data-parallel training on phase 10's corpus at the
     flagship recipe's global batch (B=48, 512 frames, device-resident):
     two ranks over gloo sharing the card (24 rows a rank), started by
     `torch.distributed.run` on this script (`--dp-gloo`), train the
     diffusion stage and the PitchExtractor 10 steps each through run's
     trainer, resume the diffusion stage to step 12 through run.main, and
     take one fp32 step of the diffusion stage against the same step in one
     process (tools/step_parity's bounds, the 1-process step's ReLU sides
     pinned); at the same time one rank under NCCL (`--dp-nccl`) trains
     the diffusion stage, its step-1 loss within 1e-3 of phase 10's. Gates: finite
     losses, the ranks' state digests equal after each stage, one
     checkpoint then the resume's, the 2-rank-trained weights served at B=4,
     T=512 through K1-bf16 and K2-bf16 (`launches_by_path["data
     parallel"]`). Steps/s, the gradients' all-reduce ms a step and peak
     memory per rank are reported; rank 0's logs go to
     checkpoints/chip_smoke/dp.log and dp_nccl.log;
  15. (run before 9) the rest of the vocoder family: (a) a Parallel
     WaveGAN at configs/tts/pwg.yaml's widths (30 layers, 3 stacks,
     64/128/64 channels) at the flagship's hop of 128, written from a seed
     as the reference lays out its checkpoint (torch.save, weight norm),
     imported by vocoders/torch_import into an assets dir whose config names
     the PWG, and served behind diff_params.npz and the PE at B=4, T=512
     (201 K1-bf16 launches, no K2: `launches_by_path["pwg served"]`); its
     forward in fp32 on the card against the CPU on 32 frames; (b) a
     HiFi-GAN with ResBlock2 (512 channels) trained through
     tools/train_vocoder for 10 steps at B=8, 64 frames, and one fp32 GAN
     step (128 channels) on the card against the CPU; (c) the flagship cascade with
     use_denoise on a score (201 K1-bf16, 4 K2-bf16:
     `launches_by_path["denoised"]`), its waveform finite and off the
     undenoised one; (d) MelGAN's generator (512 channels, scales 8·4·2·2,
     imported the same way), its multi-scale discriminator and both PWG
     discriminators in fp32 on the card against the CPU (relative max
     1e-4). Each part's seconds are reported; the trainer's log goes to
     checkpoints/chip_smoke/vocoders.log;
  16. (run before 9) the BiSinger paper's recipe: (a) the port's corpus
     tools on the host: a 64-item M4Singer corpus in its original layout
     converted to system 1's meta by `python -m
     bisinger_tpu_torch.tools.meta` and, through M4Singer and MFA
     TextGrids written from its durations, to system 2's by
     tools.proportional; a 32-item DB-4 speech set through
     tools.db4_meta, tools.pitch_shift and tools.mfa_prep; a 32-item
     bilingual singing set merged with both by tools.merge (gates: item
     counts, one length for phs, notes and ph_dur, the speechsing tags 0,
     1 and 2); (b) each meta binarized by `run --binarize`, then
     configs/usr/m4singer/fs2.yaml and system1.yaml (warm-started from
     it) on system 1's meta, the same with system2.yaml on system 2's,
     and configs/usr/les-m4-nus/fs2.yaml and diff.yaml on the merged
     meta, 5 steps each through run's trainer at the configs' widths in
     bf16 (gates: finite losses, no kernel launched, no esm/, lang_embed
     or style_embed key in the monolingual checkpoints); (c) a bilingual
     score served from each diffusion work dir through `run --infer` with
     the flagship's vocoder and the model's own f0 (the configs set
     pe_enable and no pe_ckpt): 201 K1-bf16 and 4 K2-bf16 launches
     (`launches_by_path["16 served ..."]`), a finite waveform, and for
     systems 1 and 2 the English phones through the system's EN->CN
     table. Steps/s, peak memory and the phase's seconds are reported;
     the log goes to checkpoints/chip_smoke/paper.log;
  17. (run before 9) the model and data variants, in bf16 at the configs'
     widths and batching, 5 steps a stage (`variants_phase`): (a) phase
     13's TextGrid corpus binarized with speaker vectors and loud_norm,
     lj/fs2 and lj_ds_beta6 with the CRF duration head, speaker vectors,
     LEFT relu FFNs and the energy embedding under energy_convention pow10,
     one request with a speaker vector served (16 K1-bf16, 4 K2-bf16:
     `launches_by_path["17 served (a) ..."]`); (b) phase 10's corpus with
     long silences trimmed, the flagship's FFT-Singer and diffusion stages
     with the mixture duration head, split speaker ids, relative positions
     and swish FFNs, and a PitchExtractor with LEFT convs and standard f0,
     a bilingual score served with that PE run as the diffusion run's
     pe_ckpt (201, 4); (c) the diffusion
     stage with the FFT denoiser, the score served with no K1 launch (0,
     4). Gates: finite losses, non-zero gradients, no kernel launched in a
     train step, the served launch counts, finite non-silent waveforms,
     one fp32 step of each variant task on the card against the CPU. The
     log goes to checkpoints/chip_smoke/variants.log;
  18. (run before 9) training runs' work dirs served as JAX serves them,
     and the JAX scripts' counterparts (`work_dirs_phase`): (a) phase 10's
     FFT-Singer work dir (the conditioner's own mel, no diffusion) through
     `run --infer --exp_name fs2` and through the server's `main
     --exp_name fs2` (one HTTP request, its PCM the CLI's waveform): no K1
     launch, 4 K2-bf16 each; (b) phase 12's popcs_fs2 and phase 13's lj/fs2
     work dirs (0, 4 each); (c) phase 10's diffusion work dir with pe_ckpt
     at phase 11's PE run, its f0 within 1 Hz of that PE applied directly
     (201, 4); (d) every tool of bisinger_tpu_torch/tools (train_flagship
     at 16 items and 2 steps a stage, then its export through
     from_checkpoint; flagship_artifacts; sampler_quality on the flagship:
     1241 K1-bf16 launches; bench_train; profile_split at B=8, T=1024;
     bench_serving; train_convergence; bench_pipeline) at small step counts
     and full width, each with its JSON lines and launches; the tools'
     output goes to checkpoints/chip_smoke/tools.log;
  19. (run before 9, its torchrun launches beside 18) sequence and
     pipeline parallelism over gloo ranks sharing the card, at the
     flagship's widths (`par_start`, `par_phase`): (a) a 4096-frame batch
     (21.8 s of audio) at B=1 through synthesize() over 2 seq ranks in
     bf16 and fp32 (the conditioner whole on each rank, PLMS-200 with K1
     on each rank's frames widened by 75, the PE and the NSF HiFi-GAN on
     theirs), against one process's unsharded run; 201 K1 and 4 K2
     launches a rank; (b) the flagship DiffNet over 5 pipe ranks (4 layers
     each, K1 in its write-last mode), B=4, T=256, 4 micro-batches: one
     call and a PLMS-200 loop against the unsplit ones; 804 K1-bf16
     launches a rank;
  20. (run before 9, its torchrun launch beside 18) tensor parallelism
     over 2 gloo ranks sharing the card, the flagship's widths, both
     routes (`tp_ranks`, `tp_phase`): under make_mesh(num_data=1,
     num_model=2) each rank runs its share of the DiffNet's, the PE's and
     the NSF HiFi-GAN's sharded layers (parallel/tensor.py), the rest
     replicated: (a) one DiffNet call at B=4, T=256 against the unsharded
     layer path (fp32 relative max 1e-4; bf16 mean TP_MEAN_BF16, with its
     control), (b) the PE and the vocoder on the same mel and f0 against
     the unsharded modules (fp32 at JAX's TP bounds), (c) one synthesize()
     at B=1, T=256 with DPM-Solver++ against one process (reported); no K1
     and no K2 launch on a TP rank, by design;
  21. (run before 9) the kernels at the JAX scripts' widths, each route
     (`widths_phase`): (a) tools/train_convergence at its default
     TC_HIDDEN 64 with a 128-channel vocoder that tools/train_vocoder
     trained 2 steps (K1 at C = 64, K2 at F = 64, 32, 16, 8), (b)
     sampler_quality's toy mode (1241 K1 calls at C = 64), (c) one PLMS call
     on random DiffNets at C = 64, 128, 384, 512 and one vocoder pass on
     random NSF generators of 128 and 1024 channels (K2 at F = 64-8 and
     512-64), (d) 3 FFT-Singer steps at the flagship's widths with remat off
     and on from the same start: the losses within 1e-5, both peak memories
     printed (its log checkpoints/chip_smoke/widths.log);
  9. both routes of each kernel against their plain versions at every
     input shape any phase launched them on (each counter records its
     shapes) that phases 3, 4 and 6 did not check: the batch and frame
     buckets of phases 5, 8, 10-19 (the mb4 stages, the plain generator's
     8·8·2·2 stages, phase 19's widened chunks and K1's write-last mode at
     a stage's 4 layers among them, phase 20's one-process reference, and
     phase 21's widths), each K1 shape at its own C, each K2 shape at its
     own F.
The host's share of phases 10, 12, 13, 16 and 17 (the corpora, phase 16's
corpus tools, and the binarizations) runs from the start in one process of
its own at the lowest CPU priority (`--prepare`, PREP_PARTS; its log
checkpoints/chip_smoke/prep.log), while the card runs phases 2-8; each of
those phases waits for its part and reports when it ran.
The last two lines are one JSON object of kernel results and
{"ok": true, "device": {...}}: each kernel's `launches` is its count over
phase 5's three synthesize() calls, `launches_by_path` its count in each
path of phases 5, 8 and 10-21, `widths_launched` the widths of its
launches over the whole run. Without a CUDA device it exits 1 and prints
no result. The weights are the trained flagship's (artifacts/flagship);
phase 5 fails, naming the file, where a checkout lacks one.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import threading
import time

import torch

BUDGET_S = 600.0  # the run fails past 10 minutes, builds included
T_START = time.perf_counter()
T_START_WALL = time.time()  # beside the background preparation's clock
FP32_PEAK = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores (data sheet)
# fp32 accuracy on the TF32 tensor cores (495 TFLOP/s dense, data sheet) takes
# three products per product (3xTF32): the fp32 routes' bound
FP32_TC_PEAK = 495e12 / 3
BF16_PEAK = 989e12  # H100 SXM bf16 dense tensor-core FLOP/s (data sheet)
HBM_RATE = 3.35e12  # H100 SXM bytes/s
# phase 6's repeat check (tools/repeat_launch.py): launches after the first of
# each bf16 kernel and case, and the seconds from the child's start to its kill
# (the cases took about 20 s together on an H100 at 500 launches, PERF.md; the
# child runs beside phases 21 and 9)
REPEAT_LAUNCHES = 500
REPEAT_TIMEOUT_S = 120.0




# GAN_REFERENCE: the fp32 GAN steps of phases 11, 13 and 15 take no float64
# witness (tools/step_parity's reading beside the gate, not a gate): on the card
# the four took 3.7-7.4 s, on the CPU 9.0-21.5 s each, room phase 20 needed under
# BUDGET_S (PERF.md §6). tests/test_torch_gpu.py takes the witness, on the CPU.


class PartTimer:
    """The seconds each part of a phase took: `part(name)` ends the part
    `name`, begun where the last one ended (or at the timer's start)."""

    def __init__(self):
        self.seconds, self._t = {}, time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        self.seconds[name] = round(now - self._t, 1)
        self._t = now


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def done(self, msg: str) -> None:
        log(f"[{self.name}] {msg} ({time.perf_counter() - self.t0:.1f} s)")

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            log(f"[{self.name}] FAILED after {time.perf_counter() - self.t0:.1f} s: {exc}")
        return False


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, ref):
    """max |got - ref|, that over max |ref|, and mean |got - ref| over mean
    |ref|."""
    diff = (got.double() - ref.double()).abs()
    err = diff.max().item()
    return (err, err / max(ref.abs().max().item(), 1e-30),
            diff.mean().item() / max(ref.abs().mean().item(), 1e-30))


def k1_inputs(B, T, C, L, gen, dev):
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)  # noqa: E731
    return (torch.relu(r(B, T, C)), r(L, B, T, 2 * C), r(L, B, C, sc=0.5),
            r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5), r(L, 2 * C, sc=0.1),
            r(L, C, 2 * C, sc=C ** -0.5), r(L, 2 * C, sc=0.1))


def k1_bf16(args):
    """K1's fp32 inputs -> the bf16 route's: bf16 activations and weights,
    fp32 biases."""
    x0, cond, step, wd, bd, wo, bo = args
    b16 = torch.bfloat16
    return (x0.to(b16), cond.to(b16), step.to(b16), wd.to(b16), bd, wo.to(b16), bo)


def k2_inputs(B, U, F, rk, rd, gen, dev):
    n_w = 2 * F * F * sum(k * len(d) for k, d in zip(rk, rd))
    x = torch.randn((B, U, F), generator=gen, device=dev)
    w = torch.randn((n_w,), generator=gen, device=dev)
    # scale each conv's block of w to unit gain: 1/sqrt(k*F)
    parts, off = [], 0
    for k, d in zip(rk, rd):
        for _ in range(2 * len(d)):
            parts.append(w[off:off + k * F * F] * (k * F) ** -0.5)
            off += k * F * F
    b = 0.1 * torch.randn((2 * sum(len(d) for d in rd), F), generator=gen, device=dev)
    return x, torch.cat(parts).contiguous(), b


# the bucket overrides of the card runs: the flagship's own buckets (16 tokens,
# 512 frames) truncate scores longer than about 2.7 s
CARD_BUCKETS = "bucket_tokens=[16,32,64,128],bucket_frames=[256,512,1024,2048]"
SCORES = [
    dict(item_name="pinyin", text="SP wo ai ni SP", notes="rest | C4 | E4 D4 | G4 | rest",
         notes_duration="0.1 | 0.3 | 0.2 0.2 | 0.5 | 0.1", spk_name="Alto-1"),
    dict(item_name="english", text="hello my love", notes="E4 D4 | C4 | D4 E4",
         notes_duration="0.2 0.2 | 0.4 | 0.3 0.3", spk_name="Tenor-1"),
    dict(item_name="mixed", text="SP wo love ni circle", notes="rest | C4 | D4 | E4 | G4 A4",
         notes_duration="0.1 | 0.3 | 0.3 | 0.3 | 0.2 0.2"),
]
# 24 pinyin words: two chunks for a server that chunks at 16 words
LONG = dict(item_name="long", text=" ".join(["wo ai ni la"] * 6),
            notes=" | ".join(["C4 | D4 | E4 | G4"] * 6),
            notes_duration=" | ".join(["0.15 | 0.15 | 0.15 | 0.25"] * 6))


def launch_counts(counters, by_path):
    """(reset, read) for the paths of a phase: reset() sets every kernel's
    count to 0 just before a path, read(part) records the counts just after
    it as by_path[part] and returns them."""
    def reset():
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0

    def read(part):
        torch.cuda.synchronize()
        by_path[part] = {k: c.launches for k, c in counters.items()}
        return by_path[part]

    return reset, read


def with_hp(svs, **over):
    """A shallow copy of a pipeline whose hyperparameters (and diffusion
    model's) have `over` set; the weights are shared."""
    out = copy.copy(svs)
    out.hp = dict(svs.hp, **over)
    out.model = copy.copy(svs.model)
    out.model.hp = out.hp
    return out


def score_entry_points(svs32, counters, by_path, n_calls, dev) -> bool:
    """Phase 8: scores through the port's own entry points on the flagship
    weights in bf16: the CLI (run.main), the HTTP server with its
    micro-batcher, and the three samplers; each part with every launch
    counter set to 0 just before it and read just after into
    `by_path[part]`. Logs one line a part; returns whether every check
    held."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    from scipy.io import wavfile

    from bisinger_tpu_torch import run
    from bisinger_tpu_torch.inference import server
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch

    reset, read = launch_counts(counters, by_path)

    def bf16_only(k1, groups):
        return {k: (0 if not k.endswith("_bf16") else
                    (k1 if k.startswith("fused_residual") else n_calls[k]) * groups)
                for k in counters}

    def report(part, secs, checks, text):
        bad = [k for k, v in checks.items() if not v]
        log(f"[8 score entry points] {part}: {text}; {secs:.2f} s; "
            + (f"FAILED {bad}" if bad else "checks " + ",".join(checks)))
        return not bad

    ok = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    httpd = None
    try:
        # ---- the CLI: three scores -> three WAVs ----
        fn = os.path.join(tmp, "scores.json")
        with open(fn, "w") as f:
            json.dump(SCORES, f)
        reset()
        t0 = time.perf_counter()
        rc = run.main(["--infer", "--input", fn, "--out", os.path.join(tmp, "out"),
                       "--hparams", CARD_BUCKETS])
        secs = time.perf_counter() - t0
        counts = read("8 CLI")
        svs = SVSInferTorch.from_checkpoint(FLAGSHIP_DIR, device=dev, hp_overrides=CARD_BUCKETS)
        k1 = n_calls["fused_residual_stack"]  # PLMS, as in phase 5
        # the same call again through infer_batch, its float audio read back
        ref = svs.infer_batch(SCORES)
        files = [wavfile.read(os.path.join(tmp, "out", f"{sc['item_name']}.wav"))
                 for sc in SCORES]
        gap = max(float(np.abs(pcm.astype(np.float64) / 32767 - np.clip(r, -1, 1)).max())
                  if len(pcm) == len(r) else np.inf for (_, pcm), r in zip(files, ref))
        checks = {
            "rc 0": rc == 0,
            "24 kHz": all(sr == 24000 for sr, _ in files),
            "frames x 128": all(len(pcm) > 0 and len(pcm) % 128 == 0 for _, pcm in files),
            "non-silent": all(np.abs(pcm).max() > 32 for _, pcm in files),
            "finite, as infer_batch": all(np.isfinite(r).all() for r in ref) and gap <= 2e-3,
            "launches": counts == bf16_only(k1, 1),
        }
        ok &= report("CLI, 3 scores, one batch", secs, checks,
                     f"samples {[len(pcm) for _, pcm in files]}, |wav| max "
                     f"{[round(float(np.abs(r).max()), 3) for r in ref]}, file vs infer_batch "
                     f"max |difference| {gap:.2e}, launches {counts}")

        # ---- the server: /health, then four concurrent requests ----
        httpd = server.serve(svs, "127.0.0.1", 0, max_batch=4, batch_window_ms=250.0,
                             max_words=16)
        port = httpd.server_address[1]
        batcher = server.SVSRequestHandler.batcher
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            health = r.status == 200 and json.loads(r.read())["status"] == "ok"
        answers = {}

        def post(i, body):
            t1 = time.perf_counter()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                         data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[i] = (r.status, r.headers.get("Transfer-Encoding"), r.read(),
                              time.perf_counter() - t1)

        bodies = [SCORES[0], dict(SCORES[1], stream=True), SCORES[2], LONG]
        reset()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i, b)) for i, b in enumerate(bodies)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        secs = time.perf_counter() - t0
        counts = read("8 server, 4 concurrent")
        groups = list(batcher.batch_sizes)

        def audio(body):
            pcm = np.frombuffer(body[44:], "<i2")
            return (body[:4] == b"RIFF" and int.from_bytes(body[24:28], "little") == 24000
                    and len(pcm) > 0 and np.abs(pcm).max() > 32)

        checks = {
            "health": health,
            "all answered 200": sorted(answers) == [0, 1, 2, 3]
            and all(a[0] == 200 for a in answers.values()),
            "24 kHz non-silent WAVs": all(audio(a[2]) for a in answers.values()),
            "streamed chunked": answers.get(1, (0, None))[1] == "chunked",
            "chunked score": len(server.split_score_chunks(LONG, 16)) == 2,
            "a group > 1": max(groups, default=0) > 1 and sum(groups) == 5,
            "launches": counts == bf16_only(k1, len(groups)),
        }
        ok &= report("server, /health + 4 concurrent requests (1 streamed, 1 of 2 chunks)",
                     secs, checks,
                     f"group sizes {groups}, per-request s "
                     f"{[round(answers[i][3], 3) for i in sorted(answers)]}, launches {counts}")
        lat = []
        reset()
        for _ in range(2):
            post(9, SCORES[0])
            lat.append(answers[9][3])
        counts = read("8 server, one at a time")
        ok &= report("server, one request at a time (B=1), twice", sum(lat),
                     {"200": answers[9][0] == 200, "launches": counts == bf16_only(k1, 2)},
                     f"per-request wall s {[round(x, 3) for x in lat]}, launches {counts}")
        httpd.shutdown()
        httpd = None

        # ---- the samplers on one short request; denoiser calls: DDPM one a
        # step, DPM-Solver++ one a step of dpm_steps, PLMS K/stride + 1 ----
        hp = svs.hp
        for label, over, k1s in (
                ("DDPM", dict(pndm_speedup=0), hp["K_step"]),
                ("DPM-Solver++", dict(diff_sampler="dpmpp"), hp.get("dpm_steps", 40)),
                ("PLMS, shallow start", dict(gaussian_start=False), k1)):
            m = with_hp(svs, **over)
            reset()
            t0 = time.perf_counter()
            wav = m.infer_once(SCORES[0])
            secs = time.perf_counter() - t0
            counts = read(f"8 sampler {label}")
            ok &= report(f"sampler {label}", secs,
                         {"finite": bool(np.isfinite(wav).all()),
                          "non-silent": float(np.abs(wav).max()) > 1e-3,
                          "launches": counts == bf16_only(k1s, 1)},
                         f"{k1s} denoiser calls, {len(wav)} samples, launches {counts}")

        # ---- the deterministic samplers, fp32 on the card against the CPU ----
        batch = svs32.items_to_batch(svs32.score_items([SCORES[0]]), t_txt=16, t_mel=32)
        g = torch.Generator().manual_seed(4)
        pins = dict(start_noise=torch.randn((1, 32, 80), generator=g),
                    nsf_phase=torch.rand((1, 9), generator=g),
                    nsf_noise=torch.randn((1, 32 * 128, 9), generator=g))
        cpu = copy.copy(svs32)
        cpu.device = torch.device("cpu")
        cpu.model, cpu.pe, cpu.vocoder = (copy.deepcopy(mod).cpu() for mod in
                                          (svs32.model, svs32.pe, svs32.vocoder))
        for label, over in (("DPM-Solver++", dict(diff_sampler="dpmpp")),
                            ("PLMS, shallow start", dict(gaussian_start=False))):
            t0 = time.perf_counter()
            on_card = with_hp(svs32, **over).synthesize(
                batch, **{k: v.to(dev) for k, v in pins.items()})
            on_cpu = with_hp(cpu, **over).synthesize(batch, **pins)
            secs = time.perf_counter() - t0
            mel_err = rel_err(on_card["mel"].cpu(), on_cpu["mel"])[0]
            wav_err = rel_err(on_card["wav"].cpu(), on_cpu["wav"])[0]
            ok &= report(f"{label}, fp32 card vs CPU on 32 frames", secs,
                         {"mel": mel_err <= 1e-3, "wav": wav_err <= 2e-3},
                         f"mel max err {mel_err:.3e} (tol 1e-3), wav max err {wav_err:.3e} "
                         "(tol 2e-3)")
    finally:
        if httpd is not None:
            httpd.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return ok


TRAIN_ITEMS = 64  # the train split (53 items) fills one batch of the flagship's 48
TRAIN_STEPS = 10  # cut from 20 to keep the smoke under its 600 s gate


def _grad_checks(model):
    """(every gradient finite, the encoder's and the DiffNet's each non-zero)."""
    finite, nonzero = True, True
    for name, p in model.named_parameters():
        g = p.grad
        if g is not None and not bool(torch.isfinite(g).all()):
            finite = False
        if ".encoder." in f".{name}" or name.startswith("denoise_fn."):
            nonzero &= g is not None and bool((g != 0).any())
    return finite, nonzero


def codec_check(binary_dir):
    """Every shard of a binarized corpus read whole by both backends of
    RecordReader, the native codec (`native/record_codec.cc`, built at first
    use) and the Python decoder: equal record for record, array by array;
    each backend's records/s on this host. (ok, text)."""
    import numpy as np

    from bisinger_tpu_torch.data.records import RecordReader

    def equal(a, b):
        if list(a) != list(b):
            return False
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                w = a[k]
                if not (isinstance(w, np.ndarray) and w.dtype == v.dtype
                        and w.shape == v.shape and np.array_equal(w, v)):
                    return False
            elif a[k] != v:
                return False
        return True

    prefixes = sorted(os.path.join(binary_dir, fn[:-5]) for fn in os.listdir(binary_dir)
                      if fn.endswith(".data"))
    t0 = time.perf_counter()
    RecordReader(prefixes[0])  # the codec's build at first use, timed apart
    build_s, secs, read = time.perf_counter() - t0, {}, {}
    for backend in ("native", "python"):
        t0 = time.perf_counter()
        read[backend] = [r for p in prefixes for r in RecordReader(p, backend=backend)]
        secs[backend] = time.perf_counter() - t0
    n = len(read["native"])
    same = n == len(read["python"]) and all(map(equal, read["native"], read["python"]))
    return same, (f"record codec: {n} records of {len(prefixes)} shards read whole by both "
                  f"backends, {'equal' if same else 'NOT equal'} record for record; native "
                  f"{n / secs['native']:.0f} records/s, Python {n / secs['python']:.0f} "
                  f"records/s on the card's host (warm: the binarizer just wrote them); the "
                  f"codec's first open {build_s:.2f} s")


def training_phase(svs, counters, by_path, dev, tmp, record, prep):
    """Phase 10: the acoustic training path on the card at the flagship's
    widths in bf16 (20 x 256 DiffNet, hidden 256) and its batch shape
    (16 tokens, 512 frames, 48 sentences): the port's synthetic corpus (64
    items, seed 0) binarized by `run --binarize`; the FFT-Singer stage
    (hparams_fs2.json) and the diffusion stage (hparams_diff.json, fs2
    warm-started from diff_params.npz) for 10 steps each through run's
    trainer on the device-resident corpus; `--validate` and a resume to step
    12; the gates; the trained weights served through K1 and K2. Each part's
    launch counts go into `by_path`. The corpus stays in `tmp` for phase 11;
    `record` gets each stage's loss at step 1 (phase 14 reads the diffusion
    stage's). Returns (ok, lines)."""
    import contextlib

    import numpy as np

    from bisinger_tpu_torch import native, run
    from bisinger_tpu_torch.config import make_hparams
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch, make_batch
    from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
    from bisinger_tpu_torch.tools.step_parity import step_parity
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.training.tasks import AuxDecoderMIDITask, DiffSingerMIDITask
    from bisinger_tpu_torch.weights import export_flax_params, load_flax_params, load_npz

    repo = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(repo, "checkpoints", "chip_smoke")  # gitignored
    os.makedirs(out_dir, exist_ok=True)
    log_fn = os.path.join(out_dir, "training.log")
    lines, checks = [], {}

    reset, read = launch_counts(counters, by_path)

    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        # ---- 1. the corpus and its binarization (`prep_training`) ----
        res = prep.wait("training")
        with open(log_fn, "w") as f:
            f.write(res["stdout"] + res["stderr"])
        checks["binarize rc 0"] = res["rc"] == 0
        if res["rc"] != 0:
            return False, [f"binarize failed: {res['stderr'][-2000:]}"]
        lines.append(prep.binarize_line(res, "", 8))
        ok, text = codec_check(os.path.join(tmp, "binary"))
        checks["the shards read alike by both backends"] = ok
        lines.append(text)

        stats = {}
        native.counter.records = 0
        with open(log_fn, "a") as logf, contextlib.redirect_stdout(logf):
            for stage, label in (("fs2", "FFT-Singer"), ("diff", "diffusion")):
                tr = run.trainer_from_args(run.parse_args(
                    ["--config", f"{stage}.json", "--exp_name", stage]))
                grads = {}

                def on_step(step, metrics, tr=tr, grads=grads):
                    if step <= 2:  # the DiffNet's zero-initialised output projection
                        # (flax's init) passes no gradient into it at step 1
                        grads[step] = _grad_checks(tr.task.model)

                torch.cuda.reset_peak_memory_stats()
                reset()
                tr.fit(on_step=on_step)
                counts = read(f"10 train {stage}")
                mem = torch.cuda.max_memory_allocated() / 2 ** 30
                log = tr.train_log
                t1, tn = log[0][1], log[-1][1]
                first_s = t1 - tr.loop_started
                steady = (len(log) - 1) / (tn - t1)
                losses = [m["total_loss"] for _, _, m in log]
                stats[stage] = dict(first_s=first_s, steps_per_s=steady, mem=mem,
                                    loss1=losses[0], loss_last=losses[-1])
                record[f"{stage} loss1"] = losses[0]
                checks[f"{stage} losses finite"] = all(np.isfinite(x) for x in losses)
                checks[f"{stage} grads finite"] = all(g[0] for g in grads.values())
                checks[f"{stage} encoder/DiffNet grads non-zero"] = grads[2][1]
                checks[f"{stage} no kernel launched in training"] = not any(counts.values())
                checks[f"{stage} {TRAIN_STEPS} steps"] = tr.global_step == TRAIN_STEPS
                checks[f"{stage} dataset read natively"] = native.counter.records > 0
                batch_rows = tr.task.hp["max_sentences"]
                lines.append(
                    f"{label} stage (B={batch_rows}, 16 tokens, 512 frames, bf16): corpus "
                    f"{tr.corpus_bytes / 1e6:.1f} MB on the card; first step {first_s:.2f} s, "
                    f"then {steady:.2f} steps/s; peak memory {mem:.2f} GiB; loss step 1 "
                    f"{losses[0]:.4f}, step {TRAIN_STEPS} {losses[-1]:.4f}; records decoded "
                    f"natively {native.counter.records}; launches {counts}")
                native.counter.records = 0
            reset()
            rc_val = run.main(["--config", "diff.json", "--exp_name", "diff", "--validate"])
            rc_res = run.main(["--config", "diff.json", "--exp_name", "diff", "--max_updates",
                               str(TRAIN_STEPS + 2)])
            counts = read("10 validate and resume diff")
        with open(log_fn) as f:
            text = f.read()
        val = [ln for ln in text.splitlines() if ln.startswith("| validate: total_loss=")]
        ckpt = CheckpointManager(os.path.join(tmp, "checkpoints", "diff", "ckpt"))
        checks["validate"] = rc_val == 0 and len(val) == 1 and np.isfinite(
            float(val[0].split("=")[1]))
        checks[f"resume to {TRAIN_STEPS + 2}"] = (rc_res == 0 and f"| resumed from step {TRAIN_STEPS}" in text
                                  and ckpt.latest_step() == TRAIN_STEPS + 2)
        checks["no kernel launched in validate/resume"] = not any(counts.values())
        lines.append(f"--validate: {val[0][2:] if val else 'missing'}; resume: latest "
                     f"checkpoint {ckpt.latest_step()}")

        # ---- a 0-step export reproduces diff_params.npz ----
        ref = load_npz(os.path.join(FLAGSHIP_DIR, "diff_params.npz"))
        vocab0 = int(ref["fs2/token_embed/embed/embedding"].shape[0])
        task0 = DiffSingerMIDITask(svs.hp, vocab0, device=dev)
        task0.load_state(ref)
        got = export_flax_params(task0.model)
        checks["0-step export bit-identical"] = set(got) == set(ref) and all(
            np.array_equal(got[k], ref[k]) for k in ref)
        del task0

        # ---- fp32 card vs CPU: one train step of each task ----
        hp32 = make_hparams(dict(svs.hp, compute_dtype="float32", dropout=0.0,
                                 predictor_dropout=0.0))
        b = make_batch(4, 16, 64, vocab0, seed=5)
        r = np.random.RandomState(5)
        b.update(mels=(r.randn(4, 64, 80) * 0.5 - 3).astype(np.float32),
                 word_boundary=r.randint(0, 2, (4, 16)))
        b["mels"][b["mel2ph"] == 0] = 0.0
        g = torch.Generator().manual_seed(5)
        pins = dict(t=torch.randint(0, svs.hp["K_step"], (4,), generator=g),
                    noise=torch.randn((4, 64, 80), generator=g))
        fs2_params = {k[4:]: v for k, v in ref.items() if k.startswith("fs2/")}
        reset()
        for label, cls, params, pin in (("FFT-Singer", AuxDecoderMIDITask, fs2_params, {}),
                                        ("diffusion", DiffSingerMIDITask, ref, pins)):
            with prep.paused():
                ok, text = step_parity(lambda d, cls=cls: cls(hp32, vocab0, device=d), params,
                                       b, pin, dev)
            checks[f"{label} fp32 card vs CPU"] = ok
            lines.append(f"{label} fp32 step card vs CPU (4 x 16 tokens x 64 frames): {text}")
        checks["no kernel launched in the parity steps"] = not any(read("10 parity").values())

        # ---- serve what was trained: the latest checkpoint's params.npz ----
        trained = os.path.join(ckpt.directory, str(ckpt.latest_step()), "params.npz")
        flat = load_npz(trained)
        vocab = int(flat["fs2/token_embed/embed/embedding"].shape[0])
        model = GaussianDiffusion(svs.hp, vocab, svs.hp["audio_num_mel_bins"])
        load_flax_params(model, flat)
        served = SVSInferTorch(svs.hp, model, svs.pe, svs.vocoder, dev)
        batch = make_batch(4, 16, 512, vocab, seed=9)
        reset()
        t0 = time.perf_counter()
        out = served.synthesize(batch, generator=torch.Generator(device=dev).manual_seed(9))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read("trained")
        wav = out["wav"]
        checks["trained weights served: audio finite"] = bool(torch.isfinite(wav).all()) and \
            tuple(wav.shape) == (4, 512 * 128)
        checks["trained weights served: K1-bf16 and K2-bf16 launched"] = (
            counts["fused_residual_stack_bf16"] > 0 and counts["fused_mrf_stage_bf16"] > 0)
        lines.append(f"trained diffusion weights ({os.path.relpath(trained, tmp)}, vocab "
                     f"{vocab}) served at B=4, T=512 with the flagship PE and vocoder: wav "
                     f"{tuple(wav.shape)}, |wav| max {float(wav.abs().max()):.3f}, {secs:.2f} s, "
                     f"launches {counts}")
        lines.append("steps/s (first step apart) and peak GiB: " + json.dumps(
            {k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in stats.items()}))
    finally:
        os.chdir(cwd)
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


def _pe_f0_mae(task, batch):
    """Mean |f0 predicted - f0| in Hz over the voiced, non-padding frames of
    a validation batch (log-normalised f0, as the flagship's)."""
    with torch.no_grad():
        pred = task.infer_step(batch["mels"])["f0_denorm_pred"]
        voiced = (batch["uv"] == 0) & (batch["mel2ph"] > 0)
        return float((pred - 2.0 ** batch["f0"]).abs()[voiced].mean())


MB4 = dict(vocoder_multiband=4, upsample_rates=[8, 4], upsample_kernel_sizes=[16, 8])


def cascade_phase(svs, counters, by_path, dev, tmp, prep):
    """Phase 11: the rest of the flagship cascade trained on the card in bf16
    at full width, only the step counts cut. The PitchExtractor through
    run's trainer on phase 10's corpus (hparams_diff.json with the keys of
    configs/tts/pe.yaml; B=48, 16 tokens, 512 frames, device-resident), 20
    steps, --validate, a resume to 12; the NSF HiFi-GAN through
    tools/train_vocoder at the flagship recipe's setting (512 channels, B=8,
    64 frames), 10 steps in full band and 10 in mb4. Gates: finite losses, a
    non-zero gradient on every PE parameter, the running statistics moved,
    no K1 or K2 launch in any train step, one fp32 step of each task on the
    card against the CPU (the PE from its initialisation and from the PE
    trained here, each read against its float64 step; the GAN on a voiced
    f0). Then the trained PE and full-band generator with diff_params.npz,
    through SVSInferTorch.from_checkpoint at B=4, T=512 (K1-bf16 and
    K2-bf16, `launches_by_path["trained_cascade"]`), and the
    mb4 generator on the same mel through K2 and PQMF in both routes
    (`launches_by_path["mb4"]`), bf16 against fp32 within the JAX package's
    bf16 contract. Returns (ok, lines)."""
    import contextlib
    import shutil

    import numpy as np

    from bisinger_tpu_torch import run
    from bisinger_tpu_torch.config import load_hparams_json, make_hparams
    from bisinger_tpu_torch.data.dataset import batch_to_device
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch, make_batch
    from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
    from bisinger_tpu_torch.models.pqmf import PQMF
    from bisinger_tpu_torch.tools import train_vocoder
    from bisinger_tpu_torch.tools.step_parity import gan_step_parity, step_parity
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.training.tasks import PitchExtractionTask
    from bisinger_tpu_torch.vocoders.hifigan import latest_generator
    from bisinger_tpu_torch.weights import export_flax_params, load_flax_params, load_npz

    log_fn = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints",
                          "chip_smoke", "cascade.log")
    lines, checks = [], {}

    reset, read = launch_counts(counters, by_path)

    part = PartTimer()

    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        # ---- the PitchExtractor through run's trainer ----
        hp_pe = load_hparams_json(os.path.join(FLAGSHIP_DIR, "hparams_diff.json"), dict(
            raw_data_dir=os.path.join(tmp, "raw"), binary_data_dir=os.path.join(tmp, "binary"),
            task_cls="tasks.tts.pe.PitchExtractionTask", pitch_type="frame", pitch_loss="l1",
            use_uv=True, max_updates=TRAIN_STEPS, val_check_interval=1000, log_interval=1,
            num_ckpt_keep=2))
        with open("pe.json", "w") as f:
            json.dump(hp_pe, f)
        with open(log_fn, "w") as logf, contextlib.redirect_stdout(logf):
            tr = run.trainer_from_args(run.parse_args(["--config", "pe.json", "--exp_name",
                                                       "pe"]))
            _, valid_dl = tr.build_dataloaders()
            vbatch = batch_to_device(next(iter(valid_dl)), dev)
            mae0 = _pe_f0_mae(tr.task, vbatch)
            stats0 = {k: v.clone() for k, v in tr.task.model.named_buffers()
                      if k.endswith(("running_mean", "running_var"))}
            grads = {}

            def on_step(step, metrics):
                if step == 1:
                    grads["all non-zero"] = all(
                        p.grad is not None and bool((p.grad != 0).any())
                        for p in tr.task.model.parameters())
                    grads["finite"] = all(bool(torch.isfinite(p.grad).all())
                                          for p in tr.task.model.parameters())

            torch.cuda.reset_peak_memory_stats()
            reset()
            tr.fit(on_step=on_step)
            counts = read("11 train pe")
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            mae_last = _pe_f0_mae(tr.task, vbatch)
            moved = all(not torch.equal(v, dict(tr.task.model.named_buffers())[k])
                        for k, v in stats0.items())
            log = tr.train_log
            t1, tn = log[0][1], log[-1][1]
            first_s, steady = t1 - tr.loop_started, (len(log) - 1) / (tn - t1)
            losses = [m["total_loss"] for _, _, m in log]
            reset()
            rc_val = run.main(["--config", "pe.json", "--exp_name", "pe", "--validate"])
            rc_res = run.main(["--config", "pe.json", "--exp_name", "pe", "--max_updates",
                               str(TRAIN_STEPS + 2)])
            counts_vr = read("11 validate and resume pe")
        with open(log_fn) as f:
            text = f.read()
        pe_dir = os.path.join(tmp, "checkpoints", "pe")
        ckpt = CheckpointManager(os.path.join(pe_dir, "ckpt"))
        checks["pe losses finite"] = all(np.isfinite(x) for x in losses)
        checks["pe grads finite"] = grads.get("finite", False)
        checks["pe every parameter's grad non-zero"] = grads.get("all non-zero", False)
        checks["pe running statistics moved"] = moved
        checks["pe no kernel launched in training"] = not any(counts.values())
        checks["pe validate"] = rc_val == 0 and "| validate: total_loss=" in text
        checks[f"pe resume to {TRAIN_STEPS + 2}"] = (rc_res == 0 and f"| resumed from step {TRAIN_STEPS}" in text
                                     and ckpt.latest_step() == TRAIN_STEPS + 2)
        checks["pe no kernel launched in validate/resume"] = not any(counts_vr.values())
        lines.append(
            f"PitchExtractor (B={hp_pe['max_sentences']}, 512 frames, bf16): first step "
            f"{first_s:.2f} s, then {steady:.2f} steps/s; peak memory {mem:.2f} GiB; loss step 1 "
            f"{losses[0]:.4f}, step {TRAIN_STEPS} {losses[-1]:.4f}; validation f0 MAE "
            f"{mae0:.2f} Hz at step 0, {mae_last:.2f} Hz at step {TRAIN_STEPS}; launches {counts}; "
            f"resume: latest checkpoint {ckpt.latest_step()}")
        stats = {"pe": dict(first_s=first_s, steps_per_s=steady, mem=mem, mae0=mae0,
                            mae_last=mae_last)}
        part("pe training, validate, resume")

        # fp32 PE step, card vs CPU (dropout masks pinned), from the
        # initialisation (the recipe's first step) and from the PE trained here
        hp32 = make_hparams(dict(hp_pe, compute_dtype="float32"))
        b = {k: v[:4, :128].cpu().numpy() for k, v in vbatch.items()
             if k in ("mels", "mel2ph", "f0", "uv")}
        init = export_flax_params(PitchExtractionTask(hp32, device="cpu").model)
        reset()
        for label, params in (("initialisation", init), ("PE trained here", load_npz(
                os.path.join(ckpt.directory, str(ckpt.latest_step()), "params.npz")))):
            with prep.paused():
                ok, ptext = step_parity(lambda d: PitchExtractionTask(hp32, device=d), params,
                                        b, {}, dev, reference=True)
            checks[f"pe fp32 card vs CPU from the {label}"] = ok
            lines.append(f"PitchExtractor fp32 step card vs CPU from the {label} (4 x 128 "
                         f"frames): {ptext}")
        checks["pe no kernel launched in the parity steps"] = not any(
            read("11 parity pe").values())
        part("pe parity steps")

        # ---- the vocoder, full band and mb4, through tools/train_vocoder ----
        gens = {}
        for variant, mb in (("full band", 1), ("mb4", 4)):
            per_step = []

            def on_step(step, metrics, per_step=per_step):
                per_step.append(({k: c.launches for k, c in counters.items()},
                                 torch.cuda.max_memory_allocated()))

            cfg = dict(train_vocoder.settings(), steps=TRAIN_STEPS, batch=8, frames=64,
                       channels=512, multiband=mb, out_dir=os.path.join(tmp, f"voc_mb{mb}"))
            torch.cuda.reset_peak_memory_stats()
            reset()
            with open(log_fn, "a") as logf, contextlib.redirect_stderr(logf):
                summary = train_vocoder.run(cfg, device=dev, on_step=on_step)
            if per_step:  # the counts after the last train step, before the round trip
                by_path[f"11 train vocoder {variant}"] = per_step[-1][0]
            mem = per_step[-1][1] / 2 ** 30 if per_step else float("nan")
            key = variant.replace(" ", "_")
            checks[f"{key} {TRAIN_STEPS} steps"] = len(per_step) == TRAIN_STEPS
            checks[f"{key} D and G losses finite"] = bool(np.isfinite([
                summary.get(k, np.nan) for k in ("gen_mel_first", "gen_mel_last",
                                                 "disc_loss_first", "disc_loss_last")]).all())
            checks[f"{key} no kernel launched in any train step"] = all(
                not any(n.values()) for n, _ in per_step)
            gens[mb] = latest_generator(os.path.join(cfg["out_dir"], "vocoder"))
            lines.append(
                f"vocoder {variant} (512 channels, B=8, 64 frames, bf16): "
                f"{summary.get('steps_per_s', float('nan')):.2f} steps/s (first step apart); "
                f"peak memory {mem:.2f} GiB; gen_mel {summary.get('gen_mel_first', np.nan):.4f} "
                f"at step 1, {summary.get('gen_mel_last', np.nan):.4f} at {TRAIN_STEPS}; "
                f"disc_loss {summary.get('disc_loss_first', np.nan):.4f} -> "
                f"{summary.get('disc_loss_last', np.nan):.4f}; mel L1 of the round trip "
                f"{summary.get('mel_l1_vocoded_init', np.nan):.3f} (init) -> "
                f"{summary.get('mel_l1_vocoded_trained', np.nan):.3f}; the script's ok "
                f"{summary.get('ok')}")
            stats[key] = dict(steps_per_s=summary.get("steps_per_s", float("nan")), mem=mem)
            part(f"{variant} training")
            # fp32 GAN step, card vs CPU, voiced
            reset()
            with prep.paused():
                ok, gtext = gan_step_parity(make_hparams(dict(
                    compute_dtype="float32", **(MB4 if mb == 4 else {}))), dev,
                    reference_device=None)  # GAN_REFERENCE
            checks[f"{key} fp32 GAN step card vs CPU"] = ok
            lines.append(f"{variant} fp32 GAN step card vs CPU (512 channels, B=2, 32 frames, "
                         f"voiced): {gtext}")
            checks[f"{key} no kernel launched in the parity steps"] = not any(
                read(f"11 parity {key}").values())
            part(f"{variant} parity step")

        # ---- serve what was trained ----
        cascade = os.path.join(tmp, "cascade")
        os.makedirs(os.path.join(cascade, "vocoder"))
        for fn in ("hparams_diff.json", "phone_set.json", "spk_map.json", "diff_params.npz"):
            os.symlink(os.path.join(FLAGSHIP_DIR, fn), os.path.join(cascade, fn))
        for fn in ("pe_params.npz", "pe_batch_stats.npz"):
            shutil.copy(os.path.join(pe_dir, fn), cascade)
        shutil.copy(gens[1], os.path.join(cascade, "vocoder"))
        served = SVSInferTorch.from_checkpoint(cascade, device=dev)
        vocab = served.vocab_size
        batch = make_batch(4, 16, 512, vocab, seed=9)
        reset()
        t0 = time.perf_counter()
        out = served.synthesize(batch, generator=torch.Generator(device=dev).manual_seed(9))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read("trained_cascade")
        wav = out["wav"]
        checks["trained cascade served: audio finite"] = bool(torch.isfinite(wav).all()) and \
            tuple(wav.shape) == (4, 512 * 128)
        checks["trained cascade served: K1-bf16 and K2-bf16 launched"] = (
            counts["fused_residual_stack_bf16"] > 0 and counts["fused_mrf_stage_bf16"] > 0)
        lines.append(f"trained PE and full-band vocoder with diff_params.npz through "
                     f"from_checkpoint at B=4, T=512: wav {tuple(wav.shape)}, |wav| max "
                     f"{float(wav.abs().max()):.3f}, {secs:.2f} s, launches {counts}")

        # the mb4 generator on the same mel, both routes
        flat = load_npz(gens[4])
        g = torch.Generator().manual_seed(4)
        pins = dict(phase=torch.rand(4, 9, generator=g).to(dev),
                    noise=torch.randn(4, 512 * 128, 9, generator=g).to(dev))
        wavs = {}
        reset()
        for dt in ("bfloat16", "float32"):
            voc = HifiGanGenerator(make_hparams(dict(
                served.hp, compute_dtype=dt, **MB4)))
            load_flax_params(voc, flat)
            voc.to(dev).eval()
            with torch.no_grad():
                wavs[dt] = PQMF(4).synthesis(voc(out["mel"], out["f0"], **pins)).float()
        counts = read("mb4")
        w16, w32 = wavs["bfloat16"], wavs["float32"]
        scale = float(w32.abs().mean())
        mean_gap = float((w16 - w32).abs().mean()) / max(scale, 1e-30)
        max_gap = float((w16 - w32).abs().max()) / max(scale, 1e-30)
        checks["mb4 served: finite, non-silent, T x 128 samples"] = (
            bool(torch.isfinite(w16).all()) and tuple(w16.shape) == (4, 512 * 128)
            and float(w16.abs().max()) > 1e-3)
        checks["mb4 served: K2 in both routes"] = (counts["fused_mrf_stage_bf16"] == 2
                                                   and counts["fused_mrf_stage"] == 2)
        checks["mb4 bf16 within the bf16 contract"] = mean_gap < 0.02 and max_gap < 0.2
        lines.append(f"mb4 generator (trained above) on the cascade's mel through K2 and PQMF: "
                     f"wav {tuple(w16.shape)}, |wav| max {float(w16.abs().max()):.3f}; bf16 "
                     f"against fp32 mean {mean_gap:.2e} / max {max_gap:.2e} of mean |fp32| "
                     f"(contract 2e-2 / 2e-1); launches {counts}")
        lines.append("steps/s (first step apart), peak GiB, f0 MAE: " + json.dumps(
            {k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in stats.items()}))
        part("serving")
        lines.append(f"seconds a part: {json.dumps(part.seconds)}")
    finally:
        os.chdir(cwd)
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


POPCS_ITEMS = 64
POPCS_SCORE = dict(  # phoneme level: the synthetic PopCS corpus's phone set
    item_name="popcs", input_type="phoneme", ph_seq="<SP> sh ang x in h ao m a l i <SP>",
    note_seq="rest C4 C4 D4 D4 E4 E4 F4 F4 G4 G4 rest",
    note_dur_seq="0.2 0.3 0.3 0.3 0.3 0.3 0.3 0.3 0.3 0.4 0.4 0.2",
    is_slur_seq=" ".join(["0"] * 12), lang_seq=" ".join(["1"] * 12))


def popcs_phase(counters, by_path, dev, tmp, card, prep):
    """Phase 12: DiffSinger's PopCS family from the repo's own YAML configs,
    trained and served on the card in bf16 (the configs' compute_dtype) at
    their own widths and batching; only the steps are cut. The synthetic
    corpus (64 items, fmt "popcs") binarized by `run --binarize --config
    configs/usr/popcs_fs2.yaml` (MidiSingingBinarizer, the Praat-AC tracker);
    popcs_fs2 (FastSpeech2Task: hidden 256, 4 + 4 FFT layers, frame pitch
    with uv; max_tokens 18000) for 10 steps, --validate, a resume to 12;
    popcs_ds_beta6 (T=100, K=51, DiffNet 20 x 256) for 10 steps warm-started
    from popcs_fs2's work dir; the mels popcs_fs2 predicts for every item
    (given durations and f0) written to an fs2_mel_dir, and
    popcs_ds_beta6_offline for 10 steps on them. Then popcs_ds_beta6's work
    dir served through SVSInferTorch.from_work_dir with the flagship's
    vocoder and no PE (f0 from the model's pitch predictor): shallow PLMS at
    pndm_speedup 1 over K=51, K1-bf16 once a denoiser call (K/speedup + 1 =
    52) and K2-bf16 once an MRF stage (4). Last, one fp32 step on the card
    against the CPU (tools/step_parity) of FastSpeech2Task with frame pitch,
    uv and energy on, and of DiffSingerOfflineTask. `card` (nvidia-smi's name
    and power limit) goes beside the times. Returns (ok, lines)."""
    import contextlib

    import numpy as np

    from bisinger_tpu_torch import run
    from bisinger_tpu_torch.config import apply_overrides, load_hparams
    from bisinger_tpu_torch.data.dataset import DataLoader, M4SingerDataset, batch_to_device
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch
    from bisinger_tpu_torch.tools.step_parity import step_parity
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.training.tasks import DiffSingerOfflineTask, FastSpeech2Task
    from bisinger_tpu_torch.weights import load_flax_params, load_npz

    repo = os.path.dirname(os.path.abspath(__file__))
    cfg = {name: os.path.join(repo, "configs", "usr", f"{name}.yaml")
           for name in ("popcs_fs2", "popcs_ds_beta6", "popcs_ds_beta6_offline")}
    log_fn = os.path.join(repo, "checkpoints", "chip_smoke", "popcs.log")
    root = os.path.join(tmp, "popcs")
    lines, checks, stats = [], {}, {}

    reset, read = launch_counts(counters, by_path)

    common = f"{popcs_data(root)},log_interval=1,val_check_interval=1000,num_ckpt_keep=2"
    res = prep.wait("popcs")  # the corpus and its binarization (`prep_popcs`)
    cwd = os.getcwd()
    try:
        os.chdir(root)
        with open(log_fn, "w") as f:
            f.write(res["stdout"] + res["stderr"])
        checks["binarize rc 0"] = res["rc"] == 0
        if res["rc"] != 0:
            return False, [f"binarize failed: {res['stderr'][-2000:]}"]
        lines.append(prep.binarize_line(res, " (MidiSingingBinarizer)", 8))

        def train(name, extra="", steps=TRAIN_STEPS):
            """`name`'s config for `steps` steps in work dir `name`: (trainer, launches)."""
            tr = run.trainer_from_args(run.parse_args(
                ["--config", cfg[name], "--exp_name", name, "--hparams",
                 f"{common},max_updates={steps}{extra}"]))
            torch.cuda.reset_peak_memory_stats()
            reset()
            tr.fit()
            counts = read(f"12 train {name}")
            log = tr.train_log
            t1, tn = log[0][1], log[-1][1]
            losses = [m["total_loss"] for _, _, m in log]
            stats[name] = dict(first_s=t1 - tr.loop_started,
                               steps_per_s=(len(log) - 1) / (tn - t1),
                               mem=torch.cuda.max_memory_allocated() / 2 ** 30,
                               loss1=losses[0], loss_last=losses[-1])
            checks[f"{name} losses finite"] = all(
                np.isfinite(v) for _, _, m in log for v in m.values())
            checks[f"{name} {steps} steps"] = tr.global_step == steps
            checks[f"{name} no kernel launched in training"] = not any(counts.values())
            hp = tr.task.hp
            st = stats[name]
            lines.append(
                f"{name} ({hp['task_cls'].rsplit('.', 1)[-1]}, hidden {hp['hidden_size']}, "
                f"{hp['enc_layers']} + {hp['dec_layers']} FFT layers, "
                + (f"T={hp['timesteps']} K={hp['K_step']} DiffNet {hp['residual_layers']} x "
                   f"{hp['residual_channels']}, " if name != "popcs_fs2" else "")
                + f"max_tokens {hp['max_tokens']}, bf16): first step {st['first_s']:.2f} s, "
                f"then {st['steps_per_s']:.2f} steps/s; peak memory {st['mem']:.2f} GiB; loss "
                f"step 1 {st['loss1']:.4f}, step {steps} {st['loss_last']:.4f}; launches {counts}")
            return tr

        with open(log_fn, "a") as logf, contextlib.redirect_stdout(logf):
            tr_fs2 = train("popcs_fs2")
            reset()
            rc_val = run.main(["--config", cfg["popcs_fs2"], "--exp_name", "popcs_fs2",
                               "--validate"])
            rc_res = run.main(["--config", cfg["popcs_fs2"], "--exp_name", "popcs_fs2",
                               "--max_updates", str(TRAIN_STEPS + 2)])
            counts_vr = read("12 validate and resume popcs_fs2")
            fs2_dir = os.path.join(root, "checkpoints", "popcs_fs2")
            train("popcs_ds_beta6", f",fs2_ckpt={fs2_dir}")

            # the fs2 stage's mels of every item (given mel2ph, f0 and uv), one
            # .npy per item: the offline task's recorded fs2 mels
            fs2_mel_dir = os.path.join(root, "fs2_mels")
            os.makedirs(fs2_mel_dir)
            fs2_hp = tr_fs2.task.hp
            ckpt = CheckpointManager(os.path.join(fs2_dir, "ckpt"))
            fs2_task = FastSpeech2Task(fs2_hp, tr_fs2.task.vocab_size, device=dev)
            fs2_task.load_state(load_npz(os.path.join(ckpt.directory, str(ckpt.latest_step()),
                                                      "params.npz")))
            fs2_task.model.eval()
            n_written = 0
            for split in ("train", "valid", "test"):
                for b in DataLoader(M4SingerDataset(fs2_hp, split), fs2_hp, shuffle=False):
                    with torch.no_grad():
                        mel = fs2_task.forward(batch_to_device(b, dev))["mel_out"].float().cpu()
                    for i, name in enumerate(b["item_names"]):
                        np.save(os.path.join(fs2_mel_dir, f"{name}.npy"), mel[i].numpy())
                        n_written += 1
            del fs2_task
            train("popcs_ds_beta6_offline", f",fs2_ckpt={fs2_dir},fs2_mel_dir={fs2_mel_dir}")
        with open(log_fn) as f:
            text = f.read()
        val = [ln for ln in text.splitlines() if ln.startswith("| validate: total_loss=")]
        checks["popcs_fs2 validate"] = rc_val == 0 and len(val) == 1 and np.isfinite(
            float(val[0].split("=")[1]))
        checks[f"popcs_fs2 resume to {TRAIN_STEPS + 2}"] = (rc_res == 0 and ckpt.latest_step() == TRAIN_STEPS + 2
                                            and f"| resumed from step {TRAIN_STEPS}" in text)
        checks["no kernel launched in validate/resume"] = not any(counts_vr.values())
        checks["popcs_ds_beta6 warm-started"] = text.count(f"| warm-started fs2 from {fs2_dir}") == 2
        lines.append(f"popcs_fs2 --validate: {val[0][2:] if val else 'missing'}; resume: latest "
                     f"checkpoint {ckpt.latest_step()}; {n_written} fs2 mels written for the "
                     "offline task")

        # ---- serve popcs_ds_beta6: f0 from its pitch predictor, no PE ----
        voc_dir = os.path.join(FLAGSHIP_DIR, "vocoder")
        svs = SVSInferTorch.from_work_dir(os.path.join(root, "checkpoints", "popcs_ds_beta6"),
                                          FLAGSHIP_DIR, device=dev,
                                          hp_overrides={"vocoder_ckpt": voc_dir})
        hp = svs.hp
        k, speedup = hp["K_step"], int(hp["pndm_speedup"])
        # PLMS's denoiser calls as the JAX loop makes them: 2 at the first
        # step, then one a step of np.arange(0, K, speedup) after it
        want_k1 = 2 + len(np.arange(0, k, speedup)) - 1
        svs.infer_once(POPCS_SCORE)  # warm
        reset()
        t0 = time.perf_counter()
        wav = svs.infer_once(POPCS_SCORE)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read("popcs served")
        checks["served without a PE"] = svs.pe is None
        checks["served audio finite, non-silent"] = bool(np.isfinite(wav).all()) and float(
            np.abs(wav).max()) > 1e-3
        checks[f"K1-bf16 {want_k1} launches"] = counts == {
            "fused_residual_stack": 0, "fused_residual_stack_bf16": want_k1,
            "fused_mrf_stage": 0, "fused_mrf_stage_bf16": 4}
        lines.append(f"popcs_ds_beta6 served from its work dir (from_work_dir, flagship vocoder "
                     f"{os.path.relpath(voc_dir, repo)}, pe_enable {hp['pe_enable']}: f0 from "
                     f"the pitch predictor; PLMS pndm_speedup {speedup} over K={k}, expected "
                     f"{want_k1} denoiser calls as JAX's loop makes them): {len(wav)} samples, "
                     f"|wav| max {float(np.abs(wav).max()):.3f}, warm request {serve_s:.3f} s, "
                     f"launches {counts}")
        stats["served"] = dict(request_s=serve_s)

        # ---- fp32 card vs CPU: FastSpeech2Task (pitch, uv, energy) and offline ----
        fp32 = dict(compute_dtype="float32", dropout=0.0, predictor_dropout=0.0)
        hp_fs2 = apply_overrides(load_hparams(cfg["popcs_fs2"], common),
                                 dict(fp32, use_energy_embed=True))
        hp_off = apply_overrides(load_hparams(cfg["popcs_ds_beta6_offline"], common),
                                 dict(fp32, fs2_mel_dir=fs2_mel_dir))
        data_hp = dict(hp_off, use_energy_embed=True)  # the batch carries both tasks' fields
        b = next(iter(DataLoader(M4SingerDataset(data_hp, "valid"), data_hp, shuffle=False,
                                 max_sentences=4)))
        b = {k: (v[:4, :256] if k in ("mels", "mel2ph", "f0", "uv", "energy", "fs2_mels")
                 else v[:4]) if isinstance(v, np.ndarray) and v.ndim else v for k, v in b.items()}
        g = torch.Generator().manual_seed(12)
        rows = b["txt_tokens"].shape[0]
        pins = dict(t=torch.randint(0, hp_off["K_step"], (rows,), generator=g),
                    noise=torch.randn((rows, 256, 80), generator=g))
        vocab = svs.vocab_size
        reset()
        for label, cls, hpx, work, pin in (
                ("FastSpeech2Task (frame pitch, uv, energy)", FastSpeech2Task, hp_fs2, None, {}),
                ("DiffSingerOfflineTask", DiffSingerOfflineTask, hp_off,
                 "popcs_ds_beta6_offline", pins)):
            if work is None:  # the fs2 stage trained above, with a fresh energy head
                task = cls(hpx, vocab, device="cpu")
                trained = load_npz(os.path.join(ckpt.directory, str(ckpt.latest_step()),
                                                "params.npz"))
                params = dict(task.state()["params"], **trained)
            else:
                c = CheckpointManager(os.path.join(root, "checkpoints", work, "ckpt"))
                params = load_npz(os.path.join(c.directory, str(c.latest_step()), "params.npz"))
            with prep.paused():
                ok, text = step_parity(lambda d, cls=cls, hpx=hpx: cls(hpx, vocab, device=d),
                                       params, b, pin, dev)
            checks[f"{label} fp32 card vs CPU"] = ok
            lines.append(f"{label} fp32 step card vs CPU ({rows} x "
                         f"{b['txt_tokens'].shape[1]} tokens x 256 frames, every loss): {text}")
        checks["no kernel launched in the parity steps"] = not any(read("12 parity").values())
        lines.append(f"steps/s (first step apart), peak GiB, served request s on {card}: "
                     + json.dumps({k: {kk: round(vv, 4) for kk, vv in v.items()}
                                   for k, v in stats.items()}))
    finally:
        os.chdir(cwd)
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


# ---- phase 13: the TTS path (DiffSpeech from the LJSpeech configs) ----------
TTS_ITEMS = 64
# an ARPAbet inventory: the phones of the TextGrid corpus (silences are "<SP>")
ARPABET = ["AA1", "AE1", "AH0", "B", "D", "EH1", "ER0", "F", "IY1", "K", "L", "M", "N",
           "OW1", "P", "R", "S", "T", "UW1", "Z"]
FRICATIVES = {"F", "S", "Z"}  # rendered as noise: unvoiced stretches inside speech
TTS_REQUEST = dict(  # phoneme level: the corpus's phones; durations come from the predictor
    item_name="tts", input_type="phoneme",
    ph_seq="<SP> K AE1 T <SP> M AA1 D ER0 N <SP> L IY1 F <SP>",
    note_seq=" ".join(["rest"] * 15), note_dur_seq=" ".join(["0.1"] * 15),
    is_slur_seq=" ".join(["0"] * 15), lang_seq=" ".join(["0"] * 15))


def textgrid_text(dur, tiers):
    """Praat's long TextGrid format for `tiers` [(name, [(xmin, xmax, text)])]."""
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             f"xmax = {dur!r}", "tiers? <exists>", f"size = {len(tiers)}", "item []:"]
    for i, (name, ivs) in enumerate(tiers, 1):
        lines += [f"    item [{i}]:", '        class = "IntervalTier"',
                  f'        name = "{name}"', "        xmin = 0", f"        xmax = {dur!r}",
                  f"        intervals: size = {len(ivs)}"]
        for j, (a, b, text) in enumerate(ivs, 1):
            lines += [f"        intervals [{j}]:", f"            xmin = {float(a)!r}",
                      f"            xmax = {float(b)!r}", f'            text = "{text}"']
    return "\n".join(lines) + "\n"


def write_textgrid_corpus(root, n_items, seed=0, sample_rate=22050, dur_range=(2.0, 4.0),
                          lexicon=None, prefix="LJ"):
    """An MFA-style speech corpus: per item a 16-bit WAV, a TextGrid with a
    words tier and a phones tier (the last, which the aligner reads; silence
    intervals empty) and a line of `meta.json` {item_name, wav_fn, tg_fn,
    txt, ph, spk}. Words of 2-4 phones from `ARPABET` (named w0, w1, ...), or
    drawn from `lexicon` {word: phones}; silences at both ends and between
    some words; the audio is a harmonic voice whose f0 glides through 90-220
    Hz, noise on the fricatives, near-silence in the pauses. Items are named
    `<prefix>001-0001`, ... tests/torch_port_helpers.py holds a copy for the
    CPU tests."""
    import numpy as np
    from scipy.io import wavfile

    os.makedirs(root, exist_ok=True)
    r = np.random.RandomState(seed)
    meta = []
    for i in range(n_items):
        total = r.uniform(*dur_range)
        n_words = max(2, int(round((total - 0.45) / 0.31)))  # ~0.31 s a word
        if lexicon is None:
            words = [list(r.choice(ARPABET, r.randint(2, 5))) for _ in range(n_words)]
            texts = ["w%d" % w for w in range(n_words)]
        else:
            texts = [sorted(lexicon)[k] for k in r.randint(0, len(lexicon), n_words)]
            words = [list(lexicon[w]) for w in texts]
        pauses = [r.rand() < 0.3 for _ in range(n_words - 1)]
        # durations: phones ~ U(0.05, 0.12) s, pauses 0.1-0.25 s, edges 0.15-0.3 s
        segs = [("", r.uniform(0.15, 0.3))]
        for w, word in enumerate(words):
            segs += [(p, r.uniform(0.05, 0.12)) for p in word]
            if w < len(pauses) and pauses[w]:
                segs.append(("", r.uniform(0.1, 0.25)))
        segs.append(("", r.uniform(0.15, 0.3)))
        bounds = np.concatenate([[0.0], np.cumsum([d for _, d in segs])])
        dur = float(bounds[-1])
        n = int(round(dur * sample_rate))
        t = np.arange(n) / sample_rate
        f0 = (150 + 50 * np.sin(2 * np.pi * t / r.uniform(0.8, 1.6) + r.uniform(0, 6))
              + r.uniform(-20, 20))
        phase = 2 * np.pi * np.cumsum(f0) / sample_rate
        voice = sum(np.sin(k * phase) / k for k in range(1, 11))
        noise = r.randn(n)
        wav = np.zeros(n)
        for (ph, _), a, b in zip(segs, bounds[:-1], bounds[1:]):
            lo, hi = int(round(a * sample_rate)), int(round(b * sample_rate))
            if ph == "":
                wav[lo:hi] = 1e-4 * noise[lo:hi]
            elif ph in FRICATIVES:
                wav[lo:hi] = 0.05 * noise[lo:hi]
            else:
                wav[lo:hi] = 0.2 * voice[lo:hi]
        name = f"{prefix}{i // 50 + 1:03d}-{i % 50 + 1:04d}"
        wav_fn = os.path.join(root, f"{name}.wav")
        wavfile.write(wav_fn, sample_rate, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        phone_tier = [(a, b, ph) for (ph, _), a, b in zip(segs, bounds[:-1], bounds[1:])]
        word_tier, k = [(0.0, bounds[1], "")], 1
        for w, word in enumerate(words):
            word_tier.append((bounds[k], bounds[k + len(word)], texts[w]))
            k += len(word)
            if segs[k][0] == "":
                word_tier.append((bounds[k], bounds[k + 1], ""))
                k += 1
        tg_fn = os.path.join(root, f"{name}.TextGrid")
        with open(tg_fn, "w") as f:
            f.write(textgrid_text(dur, [("words", word_tier), ("phones", phone_tier)]))
        ph = ["<SP>"]
        for w, word in enumerate(words):
            ph += word
            if w < len(pauses) and pauses[w]:
                ph.append("<SP>")
        ph.append("<SP>")
        meta.append(dict(item_name=name, wav_fn=wav_fn, tg_fn=tg_fn,
                         txt=" ".join(texts), ph=" ".join(ph),
                         spk="LJSpeech"))
    with open(os.path.join(root, "meta.json"), "w") as f:
        for m in meta:
            f.write(json.dumps(m) + "\n")
    return meta


def tts_phase(counters, by_path, dev, tmp, card, prep):
    """Phase 13: DiffSpeech TTS from the repo's LJSpeech configs, trained and
    served on the card in bf16 at the configs' widths and batching; only the
    steps are cut. A TextGrid corpus written here (64 items of 2-4 s at
    22.05 kHz, ARPAbet phones) binarized by `run --binarize --config
    configs/tts/lj/fs2.yaml` with binarizer_cls ZhBinarizer (the TextGrid
    binarizer, with_f0cwt, the Praat-AC tracker); lj/fs2 (the plain
    FastSpeech2 with the CWT pitch head, hidden 256, 4 + 4 layers, max_tokens
    40000) for 10 steps; lj_ds_beta6 (T=100, K=71, max_beta 0.06, DiffNet 20
    x 256) for 10 steps warm-started from lj/fs2's work dir, then
    `--validate`; the plain HiFi-GAN of configs/tts/hifigan.yaml (no NSF,
    rates 8·8·2·2, 512 channels) through tools/train_vocoder (TV_CONFIG) at
    B=8, 64 frames for 10 steps. Serving: an assets dir with the trained
    generator and the vocoder config's keys (hparams_diff.json), the
    DiffSpeech work dir through SVSInferTorch.from_work_dir (durations from
    the predictor, f0 from the CWT head, PLMS at pndm_speedup 5 over K=71 from
    a Gaussian start: 2 + len(arange(0, 71, 5)) - 1 = 16 K1-bf16 launches,
    as JAX's loop calls the denoiser; 4 K2-bf16; the fp32 routes 0), then
    `run --infer` on the card. Last, one fp32 step on the card against the CPU
    (tools/step_parity) of the lj/fs2 task (4 x 256 frames) and of the plain
    GAN task (2 x 32 frames). `card` (nvidia-smi's name and power limit) goes
    beside the times. Returns (ok, lines)."""
    import contextlib

    import numpy as np
    from scipy.io import wavfile

    from bisinger_tpu_torch import run
    from bisinger_tpu_torch.config import apply_overrides, load_hparams
    from bisinger_tpu_torch.data.dataset import DataLoader, M4SingerDataset
    from bisinger_tpu_torch.inference.pipeline import SVSInferTorch
    from bisinger_tpu_torch.tools import train_vocoder
    from bisinger_tpu_torch.tools.step_parity import gan_step_parity, step_parity
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.training.tasks import AuxDecoderMIDITask
    from bisinger_tpu_torch.vocoders.hifigan import latest_generator
    from bisinger_tpu_torch.weights import load_npz

    repo = os.path.dirname(os.path.abspath(__file__))
    cfg = {name: os.path.join(repo, "configs", path) for name, path in (
        ("lj_fs2", "tts/lj/fs2.yaml"), ("lj_ds_beta6", "usr/lj_ds_beta6.yaml"),
        ("hifigan", "tts/hifigan.yaml"))}
    log_fn = os.path.join(repo, "checkpoints", "chip_smoke", "tts.log")
    root = os.path.join(tmp, "tts")
    lines, checks, stats = [], {}, {}

    reset, read = launch_counts(counters, by_path)

    common = f"{tts_data(root)},log_interval=1,val_check_interval=1000,num_ckpt_keep=2"
    res = prep.wait("tts")  # the corpus and its binarization (`prep_tts`)
    part = PartTimer()

    cwd = os.getcwd()
    try:
        os.chdir(root)
        with open(log_fn, "w") as f:
            f.write(res["stdout"] + res["stderr"])
        checks["binarize rc 0"] = res["rc"] == 0
        if res["rc"] != 0:
            return False, [f"binarize failed: {res['stderr'][-2000:]}"]
        lines.append(prep.binarize_line(res, " (TextGridBinarizer, with_f0cwt)", 8))
        stats["binarize"] = dict(seconds=res["seconds"])

        def train(name, extra=""):
            """`name`'s config for 10 steps in work dir `name`: the trainer."""
            tr = run.trainer_from_args(run.parse_args(
                ["--config", cfg[name], "--exp_name", name, "--hparams",
                 f"{common},max_updates={TRAIN_STEPS}{extra}"]))
            torch.cuda.reset_peak_memory_stats()
            reset()
            tr.fit()
            counts = read(f"13 train {name}")
            log = tr.train_log
            t1, tn = log[0][1], log[-1][1]
            first, last = log[0][2], log[-1][2]
            stats[name] = dict(first_s=t1 - tr.loop_started,
                               steps_per_s=(len(log) - 1) / (tn - t1),
                               mem=torch.cuda.max_memory_allocated() / 2 ** 30,
                               loss1=first["total_loss"], loss_last=last["total_loss"],
                               C1=first["C"], C20=last["C"])
            checks[f"{name} losses finite"] = all(
                np.isfinite(v) for _, _, m in log for v in m.values())
            checks[f"{name} {TRAIN_STEPS} steps"] = tr.global_step == TRAIN_STEPS
            checks[f"{name} total loss fell"] = last["total_loss"] < first["total_loss"]
            checks[f"{name} no kernel launched in training"] = not any(counts.values())
            hp = tr.task.hp
            st = stats[name]
            lines.append(
                f"{name} ({hp['task_cls'].rsplit('.', 1)[-1]}, pitch_type {hp['pitch_type']}, "
                f"hidden {hp['hidden_size']}, {hp['enc_layers']} + {hp['dec_layers']} FFT "
                "layers, "
                + (f"T={hp['timesteps']} K={hp['K_step']} max_beta {hp['max_beta']} DiffNet "
                   f"{hp['residual_layers']} x {hp['residual_channels']}, "
                   if name == "lj_ds_beta6" else "")
                + f"max_tokens {hp['max_tokens']}, bf16): first step {st['first_s']:.2f} s, "
                f"then {st['steps_per_s']:.2f} steps/s; peak memory {st['mem']:.2f} GiB; loss "
                f"step 1 {st['loss1']:.4f}, step {TRAIN_STEPS} {st['loss_last']:.4f}; C "
                f"{st['C1']:.4f} -> {st['C20']:.4f}; launches {counts}")
            return tr

        with open(log_fn, "a") as logf, contextlib.redirect_stdout(logf):
            tr_fs2 = train("lj_fs2")
            fs2_dir = os.path.join(root, "checkpoints", "lj_fs2")
            train("lj_ds_beta6", f",fs2_ckpt={fs2_dir}")
            reset()
            rc_val = run.main(["--config", cfg["lj_ds_beta6"], "--exp_name", "lj_ds_beta6",
                               "--validate"])
            counts_val = read("13 validate lj_ds_beta6")
        with open(log_fn) as f:
            text = f.read()
        val = [ln for ln in text.splitlines() if ln.startswith("| validate: total_loss=")]
        checks["lj_ds_beta6 validate"] = rc_val == 0 and len(val) == 1 and np.isfinite(
            float(val[0].split("=")[1]))
        checks["no kernel launched in validation"] = not any(counts_val.values())
        checks["lj_ds_beta6 warm-started"] = f"| warm-started fs2 from {fs2_dir}" in text
        lines.append(f"lj_ds_beta6 --validate: {val[0][2:] if val else 'missing'}")

        part("lj/fs2 and lj_ds_beta6 training, validate")
        # ---- the plain HiFi-GAN through tools/train_vocoder ----
        per_step = []

        def on_step(step, metrics):
            per_step.append(({k: c.launches for k, c in counters.items()},
                             torch.cuda.max_memory_allocated()))

        voc_cfg = dict(train_vocoder.settings(), steps=TRAIN_STEPS, batch=8, frames=64,
                       channels=512, multiband=1, out_dir=os.path.join(root, "voc"),
                       config=cfg["hifigan"])
        torch.cuda.reset_peak_memory_stats()
        reset()
        with open(log_fn, "a") as logf, contextlib.redirect_stderr(logf):
            summary = train_vocoder.run(voc_cfg, device=dev, on_step=on_step)
        if per_step:
            by_path["13 train plain vocoder"] = per_step[-1][0]
        mem = per_step[-1][1] / 2 ** 30 if per_step else float("nan")
        checks[f"plain vocoder {TRAIN_STEPS} steps"] = len(per_step) == TRAIN_STEPS
        checks["plain vocoder D and G losses finite"] = bool(np.isfinite([
            summary.get(k, np.nan) for k in ("gen_mel_first", "gen_mel_last",
                                             "disc_loss_first", "disc_loss_last")]).all())
        checks["plain vocoder gen_mel fell"] = summary.get("gen_mel_last", np.inf) < \
            summary.get("gen_mel_first", -np.inf)
        checks["plain vocoder: no kernel launched in any train step"] = all(
            not any(n.values()) for n, _ in per_step)
        lines.append(
            f"plain vocoder (configs/tts/hifigan.yaml: no NSF, rates 8·8·2·2, hop 256, 512 "
            f"channels, B=8, 64 frames, bf16): {summary.get('steps_per_s', np.nan):.2f} steps/s "
            f"(first step apart); peak memory {mem:.2f} GiB; gen_mel "
            f"{summary.get('gen_mel_first', np.nan):.4f} -> "
            f"{summary.get('gen_mel_last', np.nan):.4f}; disc_loss {summary.get('disc_loss_first', np.nan):.4f} -> "
            f"{summary.get('disc_loss_last', np.nan):.4f}; mel L1 of the round trip "
            f"{summary.get('mel_l1_vocoded_init', np.nan):.3f} (init) -> "
            f"{summary.get('mel_l1_vocoded_trained', np.nan):.3f}")
        stats["plain_vocoder"] = dict(steps_per_s=summary.get("steps_per_s", np.nan), mem=mem)

        part("plain vocoder training")
        # ---- serve: the assets dir (decision (b): the vocoder's own config) ----
        assets = os.path.join(root, "assets")
        os.makedirs(os.path.join(assets, "vocoder"))
        gen_fn = latest_generator(os.path.join(voc_cfg["out_dir"], "vocoder"))
        os.replace(gen_fn, os.path.join(assets, "vocoder", os.path.basename(gen_fn)))
        voc_hp = load_hparams(cfg["hifigan"])
        with open(os.path.join(assets, "hparams_diff.json"), "w") as f:
            json.dump(voc_hp, f)
        ds_dir = os.path.join(root, "checkpoints", "lj_ds_beta6")
        svs = SVSInferTorch.from_work_dir(ds_dir, assets, device=dev)
        hp = svs.hp
        with open(os.path.join(hp["binary_data_dir"], "phone_set.json")) as f:
            phones = set(json.load(f))
        checks["request phones in the corpus's phone set"] = set(
            TTS_REQUEST["ph_seq"].split()) <= phones
        k, speedup = hp["K_step"], int(hp["pndm_speedup"])
        # PLMS's denoiser calls as the JAX loop makes them: 2 at the first
        # step, then one a step of np.arange(0, K, speedup) after it
        want = {"fused_residual_stack": 0,
                "fused_residual_stack_bf16": 2 + len(np.arange(0, k, speedup)) - 1,
                "fused_mrf_stage": 0, "fused_mrf_stage_bf16": len(voc_hp["upsample_rates"])}
        checks["vocoder from the assets config (8·8·2·2, no NSF)"] = (
            svs.vocoder.rates == [8, 8, 2, 2] and not svs.vocoder.use_nsf)
        svs.infer_once(TTS_REQUEST)  # warm
        reset()
        t0 = time.perf_counter()
        wav = svs.infer_once(TTS_REQUEST)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read("tts served")
        checks["served audio finite, non-silent, whole 256-sample frames"] = (
            bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 1e-3
            and len(wav) % 256 == 0)
        checks[f"served: K1-bf16 {want['fused_residual_stack_bf16']}, K2-bf16 "
               f"{want['fused_mrf_stage_bf16']}, fp32 0 launches"] = counts == want
        lines.append(f"lj_ds_beta6 served from its work dir (from_work_dir, the plain vocoder "
                     f"trained above from the assets dir; durations from the predictor, f0 "
                     f"from the CWT head; PLMS pndm_speedup {speedup} over K={k}, expected "
                     f"{want['fused_residual_stack_bf16']} denoiser calls): {len(wav)} samples "
                     f"at {hp['audio_sample_rate']} Hz, |wav| max {float(np.abs(wav).max()):.3f}, "
                     f"warm request {serve_s:.3f} s, launches {counts}")
        stats["served"] = dict(request_s=serve_s, audio_s=len(wav) / hp["audio_sample_rate"])

        req_fn = os.path.join(root, "request.json")
        with open(req_fn, "w") as f:
            json.dump([TTS_REQUEST], f)
        reset()
        t0 = time.perf_counter()
        with open(log_fn, "a") as logf, contextlib.redirect_stdout(logf):
            rc_inf = run.main(["--infer", "--exp_name", "lj_ds_beta6", "--ckpt_dir", assets,
                               "--input", req_fn, "--out", os.path.join(root, "out"),
                               "--device", "cuda"])
        cli_s = time.perf_counter() - t0
        counts_cli = read("tts run --infer")
        sr, cli_wav = wavfile.read(os.path.join(root, "out", "tts.wav"))
        checks["run --infer: 22.05 kHz audio, non-silent"] = (
            rc_inf == 0 and sr == 22050 and len(cli_wav) % 256 == 0
            and int(np.abs(cli_wav).max()) > 32)
        checks["run --infer launches"] = counts_cli == want
        lines.append(f"run --infer --device cuda (the work dir and the assets dir): rc {rc_inf}, "
                     f"{len(cli_wav)} samples at {sr} Hz, {cli_s:.2f} s with the loading, "
                     f"launches {counts_cli}")

        part("serving")
        # ---- fp32 card vs CPU: the lj/fs2 task (CWT head) and the plain GAN task ----
        fp32 = dict(compute_dtype="float32", dropout=0.0, predictor_dropout=0.0)
        hp_fs2 = apply_overrides(load_hparams(cfg["lj_fs2"], common), fp32)
        b = next(iter(DataLoader(M4SingerDataset(hp_fs2, "valid"), hp_fs2, shuffle=False,
                                 max_sentences=4)))
        b = {k: (v[:4, :256] if k in ("mels", "mel2ph", "f0", "uv", "cwt_spec") else v[:4])
             if isinstance(v, np.ndarray) and v.ndim else v for k, v in b.items()}
        ckpt = CheckpointManager(os.path.join(fs2_dir, "ckpt"))
        params = load_npz(os.path.join(ckpt.directory, str(ckpt.latest_step()), "params.npz"))
        vocab = tr_fs2.task.vocab_size
        reset()
        with prep.paused():
            ok, ptext = step_parity(lambda d: AuxDecoderMIDITask(hp_fs2, vocab, device=d),
                                    params, b, {}, dev)
        checks["lj/fs2 fp32 card vs CPU"] = ok
        lines.append(f"lj/fs2 (CWT head) fp32 step card vs CPU ({b['txt_tokens'].shape[0]} x "
                     f"{b['txt_tokens'].shape[1]} tokens x 256 frames, every loss, trained "
                     f"weights): {ptext}")
        with prep.paused():
            ok, gtext = gan_step_parity(load_hparams(cfg["hifigan"],
                                                     dict(compute_dtype="float32")), dev,
                                        reference_device=None)  # GAN_REFERENCE
        checks["plain GAN fp32 step card vs CPU"] = ok
        lines.append(f"plain GAN fp32 step card vs CPU (512 channels, B=2, 32 frames, no f0): "
                     f"{gtext}")
        checks["no kernel launched in the parity steps"] = not any(read("13 parity").values())
        part("parity steps")
        lines.append(f"binarize s, steps/s (first step apart), peak GiB, losses, served request "
                     f"s on {card}: " + json.dumps(
                         {k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in stats.items()}))
        lines.append(f"seconds a part: {json.dumps(part.seconds)}")
    finally:
        os.chdir(cwd)
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


# ---- phase 14: data parallelism ------------------------------------------------
DP_STEPS = 10
DP_TIMEOUT_S = 240.0  # phase 14's launches, waited for after phase 17


def _dp_train(argv, dev):
    """One stage through run's trainer on this rank: its losses, steady
    steps/s (the first step apart), the gradients' all-reduce ms a step, the
    peak memory, the digest of the state every rank must hold, the saved
    checkpoints."""
    import numpy as np

    import torch.distributed as dist

    from bisinger_tpu_torch import run

    torch.cuda.reset_peak_memory_stats(dev)
    tr = run.trainer_from_args(run.parse_args(argv))
    tr.fit(max_updates=DP_STEPS)
    log = tr.train_log
    return dict(losses=[m["total_loss"] for _, _, m in log],
                steps_per_s=(len(log) - 1) / (log[-1][1] - log[0][1]),
                allreduce_ms=float(np.mean([m["allreduce_ms"] for _, _, m in log[1:]])),
                mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                digest=tr.agree("after the stage"), ckpts=tr.ckpt.steps(),
                world=dist.get_world_size(), backend=str(dist.get_backend()))


def _dp_fp32_step(spec, dev):
    """The fp32 step of `spec` on this rank's rows (t and noise at the global
    shape, each ReLU pinned to the side the 1-process step took), as it falls
    too; rank 0 holds both against the 1-process step with tools/step_parity's
    bounds. Returns (ok, text, digest): ok and text on rank 0 (None on the
    others), the digest of the step's parameters, checked equal on every rank."""
    import numpy as np

    from bisinger_tpu_torch.config import load_hparams_json
    from bisinger_tpu_torch.parallel import mesh as dp
    from bisinger_tpu_torch.tools.step_parity import Kinks, Step, _task_step, compare
    from bisinger_tpu_torch.training.tasks import DiffSingerMIDITask
    from bisinger_tpu_torch.weights import load_npz

    hp = load_hparams_json(spec["hp"])
    params = load_npz(spec["params"])
    n, r = 4 // dp.world_size(), dp.rank()
    data = dict(np.load(spec["batch"]))
    rows = {k: v[r * n:(r + 1) * n] for k, v in data.items()}
    pins = {k: torch.as_tensor(v) for k, v in np.load(spec["pins"]).items()}
    kinks = Kinks()
    kinks.sides = [side[r * n:(r + 1) * n] for side in torch.load(spec["kinks"])]
    make = lambda d: DiffSingerMIDITask(hp, spec["vocab"], device=d)  # noqa: E731
    pinned = _task_step(make, params, rows, pins, dev, False, kinks.pin())
    raw = _task_step(make, params, rows, pins, dev, False)
    digest = dp.check_identical([torch.as_tensor(v) for v in pinned.params[0].values()],
                                "fp32 step")
    if r != 0:
        return None, None, digest
    one = np.load(spec["one"])
    step = lambda part: {k[len(part) + 1:]: one[k] for k in one.files  # noqa: E731
                         if k.startswith(part + "/")}
    ref = Step({k: float(v) for k, v in step("loss").items()}, [step("grad")],
               [step("param")], float(one["lr"]), float(one["max_norm"]))
    ok, text = compare(pinned, ref, kinks, raw)
    return ok, text, digest


def dp_ranks(tmp: str, nccl: bool) -> int:
    """Phase 14's ranks, one process each, started by torchrun. Over gloo,
    two ranks sharing the card: the diffusion stage and the PitchExtractor,
    DP_STEPS each, through run's trainer on phase 10's corpus; a resume of
    the diffusion stage through run.main; the fp32 step of dp_fp32.json.
    Over NCCL, one rank: the diffusion stage. Each rank writes its results
    to tmp/dp[_nccl]_rank<R>.json; rank 0's trainer log goes to
    checkpoints/chip_smoke/dp[_nccl].log."""
    import contextlib

    from bisinger_tpu_torch import full_fp32, run
    from bisinger_tpu_torch.parallel import mesh as dp
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager

    full_fp32()
    tag = "dp_nccl" if nccl else "dp"
    log_fn = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints",
                          "chip_smoke", f"{tag}.log")
    os.chdir(tmp)
    dev = dp.init_data_parallel(None if nccl else "cuda:0", None if nccl else "gloo")
    shared = [] if nccl else ["--device", "cuda:0", "--dist_backend", "gloo"]
    out = {}
    try:
        with open(log_fn if dp.is_main() else os.devnull, "w") as logf, \
                contextlib.redirect_stdout(logf):
            for label, cfg in (("diffusion", "diff.json"),) + (() if nccl else (("pe",
                                                                                  "pe.json"),)):
                out[label] = _dp_train(["--config", cfg, "--exp_name", f"{tag}_{label}",
                                        "--max_updates", str(DP_STEPS)] + shared, dev)
            if not nccl:
                rc = run.main(["--exp_name", f"{tag}_diffusion", "--max_updates",
                               str(DP_STEPS + 2)] + shared)
                out["resume"] = dict(rc=rc, ckpts=CheckpointManager(os.path.join(
                    "checkpoints", f"{tag}_diffusion", "ckpt")).steps())
                with open("dp_fp32.json") as f:
                    ok, text, digest = _dp_fp32_step(json.load(f), dev)
                out["fp32"] = dict(ok=ok, text=text, digest=digest)
        with open(f"{tag}_rank{dp.rank()}.json", "w") as f:
            json.dump(out, f)
    finally:
        dp.shutdown()
    return 0


def dp_start(svs, dev, tmp):
    """Phase 14: data-parallel training on the card, on phase 10's corpus at
    the flagship recipe's global batch (B=48, 512 frames, device-resident):
    two ranks over gloo sharing the card (24 rows a rank), started by
    torchrun, train the diffusion stage (fs2 warm-started from
    diff_params.npz) and the PitchExtractor DP_STEPS steps each through run's
    trainer, resume the diffusion stage to DP_STEPS + 2 through run.main, and
    take one fp32 step of the diffusion stage (4 x 64 frames, halves of
    unequal valid frames) held against the same step in this process; at
    the same time one rank under NCCL (torchrun --nproc_per_node 1) trains
    the diffusion stage, whose step-1 loss must equal phase 10's (the same seed, weights
    and batch) within 1e-3 of its value (a bf16 forward). Gates: finite
    losses; the ranks' digests of the whole state equal after each stage; the
    fp32 step within tools/step_parity's bounds; one checkpoint after
    DP_STEPS, then the resume's; the 2-rank-trained diffusion weights served
    at B=4, T=512 through K1-bf16 and K2-bf16 (`launches_by_path["data
    parallel"]`; phase 9 checks any new shape). This part takes the step in
    this process and starts the launches, which run beside phases 15-17;
    `dp_phase` waits for them and checks. Returns (the launches, the
    vocabulary size)."""
    import numpy as np

    from bisinger_tpu_torch.config import make_hparams
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, make_batch
    from bisinger_tpu_torch.tools.step_parity import Kinks, _task_step
    from bisinger_tpu_torch.training.tasks import DiffSingerMIDITask
    from bisinger_tpu_torch.weights import load_npz

    repo = os.path.dirname(os.path.abspath(__file__))

    # ---- the fp32 step in this process, its ReLU sides recorded ----
    params_fn = os.path.join(FLAGSHIP_DIR, "diff_params.npz")
    vocab = int(load_npz(params_fn)["fs2/token_embed/embed/embedding"].shape[0])
    hp32 = make_hparams(dict(svs.hp, compute_dtype="float32", dropout=0.0,
                             predictor_dropout=0.0))
    b = make_batch(4, 16, 64, vocab, seed=5)
    r = np.random.RandomState(5)
    b.update(mels=(r.randn(4, 64, 80) * 0.5 - 3).astype(np.float32),
             word_boundary=r.randint(0, 2, (4, 16)))
    for i, pad in enumerate((0, 4, 13, 21)):  # the halves' valid frames differ
        b["mel2ph"][i, 56 - pad:] = 0
    b["mels"][b["mel2ph"] == 0] = 0.0
    g = torch.Generator().manual_seed(5)
    pins = dict(t=torch.randint(0, hp32["K_step"], (4,), generator=g),
                noise=torch.randn((4, 64, 80), generator=g))
    kinks = Kinks()
    one = _task_step(lambda d: DiffSingerMIDITask(hp32, vocab, device=d), load_npz(params_fn),
                     b, pins, dev, False, kinks.record())
    np.savez(os.path.join(tmp, "dp_one.npz"), lr=one.lr, max_norm=one.max_norm,
             **{f"loss/{k}": v for k, v in one.losses.items()},
             **{f"grad/{k}": v for k, v in one.grads[0].items()},
             **{f"param/{k}": v for k, v in one.params[0].items()})
    np.savez(os.path.join(tmp, "dp_batch.npz"), **b)
    np.savez(os.path.join(tmp, "dp_pins.npz"), **{k: v.numpy() for k, v in pins.items()})
    torch.save(kinks.sides, os.path.join(tmp, "dp_kinks.pt"))
    with open(os.path.join(tmp, "dp_hp32.json"), "w") as f:
        json.dump(hp32, f)
    with open(os.path.join(tmp, "dp_fp32.json"), "w") as f:
        json.dump(dict(hp=os.path.join(tmp, "dp_hp32.json"), params=params_fn, vocab=vocab,
                       batch=os.path.join(tmp, "dp_batch.npz"),
                       pins=os.path.join(tmp, "dp_pins.npz"),
                       kinks=os.path.join(tmp, "dp_kinks.pt"),
                       one=os.path.join(tmp, "dp_one.npz")), f)
    del one

    # ---- the ranks: 2 over gloo on the card, and 1 under NCCL ----
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    # both launches at once: their imports and set-up overlap
    launches = DPLaunches()
    for tag, n, flag in DP_RUNS:
        with open(os.path.join(tmp, f"{tag}.out"), "w") as out:
            launches.start(tag, subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", str(n), os.path.join(repo, "chip_smoke.py"), flag, tmp],
                env=env, stdout=out, stderr=subprocess.STDOUT))
    return launches, vocab


DP_RUNS = (("dp", 2, "--dp-gloo"), ("dp_nccl", 1, "--dp-nccl"))  # (tag, ranks, flag)


class DPLaunches:
    """Phase 14's torchrun launches: each one's seconds from its start to
    its end, taken by a thread that waits on it."""

    def __init__(self):
        self.procs, self.secs = {}, {}

    def start(self, tag, proc):
        t0 = time.perf_counter()
        self.procs[tag] = proc

        def wait():
            proc.wait()
            self.secs[tag] = time.perf_counter() - t0
        threading.Thread(target=wait, daemon=True).start()

    def wait(self, timeout):
        """Until every launch has ended, or `timeout` seconds; then ends
        what still runs."""
        t0 = time.perf_counter()
        while len(self.secs) < len(self.procs) and time.perf_counter() - t0 < timeout:
            time.sleep(0.05)
        self.stop()

    def stop(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def dp_phase(started, svs, counters, by_path, dev, tmp, record):
    """Phase 14's checks, once the launches `dp_start` made (beside phases
    15-17) have ended (as `dp_start` says). Returns (ok, lines)."""
    import numpy as np

    from bisinger_tpu_torch.inference.pipeline import SVSInferTorch, make_batch
    from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.weights import load_flax_params, load_npz

    launches, vocab = started
    lines, checks = [], {}
    reset, read = launch_counts(counters, by_path)
    t0 = time.perf_counter()
    launches.wait(DP_TIMEOUT_S)
    waited, procs, secs, results = time.perf_counter() - t0, launches.procs, launches.secs, {}
    for tag, n, _ in DP_RUNS:
        if tag not in secs or procs[tag].returncode != 0:
            with open(os.path.join(tmp, f"{tag}.out")) as f:
                return False, [f"{tag} ranks failed (rc {procs[tag].returncode}"
                               f"{'' if tag in secs else f', past {DP_TIMEOUT_S:.0f} s'}): "
                               f"{f.read()[-3000:]}"]
        results[tag] = []
        for i in range(n):
            with open(os.path.join(tmp, f"{tag}_rank{i}.json")) as f:
                results[tag].append(json.load(f))
    two, (nccl,) = results["dp"], results["dp_nccl"]
    for label in ("diffusion", "pe"):
        a, c = two[0][label], two[1][label]
        checks[f"2 ranks {label}: losses finite"] = all(np.isfinite(a["losses"]))
        checks[f"2 ranks {label}: digests equal"] = a["digest"] == c["digest"]
        checks[f"2 ranks {label}: {DP_STEPS} steps, one checkpoint"] = (
            len(a["losses"]) == DP_STEPS and a["ckpts"] == [DP_STEPS])
        lines.append(
            f"{label}, 2 ranks over gloo sharing the card (global B=48, 24 rows a rank, bf16): "
            f"{a['steps_per_s']:.2f} steps/s (first step apart), gradient all-reduce "
            f"{a['allreduce_ms']:.1f} ms a step, peak memory {a['mem_gib']:.2f} / "
            f"{c['mem_gib']:.2f} GiB (rank 0 / 1), loss step 1 {a['losses'][0]:.4f}, step "
            f"{DP_STEPS} {a['losses'][-1]:.4f}, state digest {a['digest'][:12]} on both ranks")
    res = two[0]["resume"]
    checks["2-rank resume to step 12"] = (res["rc"] == 0 and two[1]["resume"]["rc"] == 0
                                          and res["ckpts"] == [DP_STEPS, DP_STEPS + 2])
    checks["fp32 step, 2 ranks vs 1"] = bool(two[0]["fp32"]["ok"])
    checks["fp32 step: digests equal"] = two[0]["fp32"]["digest"] == two[1]["fp32"]["digest"]
    lines.append(f"resume through run.main: checkpoints {res['ckpts']}; fp32 step on 2 ranks "
                 f"(4 x 16 tokens x 64 frames, valid frames 56/52/43/35) against 1 process, "
                 f"the 2-rank step with the 1-process step's ReLU sides pinned: "
                 f"{two[0]['fp32']['text']}")
    d = nccl["diffusion"]
    ref1 = record["diff loss1"]
    checks["NCCL: losses finite"] = all(np.isfinite(d["losses"]))
    checks["NCCL: step-1 loss equals phase 10's"] = (
        abs(d["losses"][0] - ref1) <= 1e-3 * abs(ref1))
    checks["NCCL: world size 1, nccl"] = d["world"] == 1 and "nccl" in d["backend"]
    lines.append(f"diffusion, 1 rank under NCCL ({d['backend']}): {d['steps_per_s']:.2f} "
                 f"steps/s, gradient all-reduce {d['allreduce_ms']:.2f} ms a step, peak "
                 f"{d['mem_gib']:.2f} GiB, loss step 1 {d['losses'][0]:.6f} (phase 10 "
                 f"{ref1:.6f}, {abs(d['losses'][0] - ref1) / abs(ref1):.2e} of it)")
    lines.append("launches (torchrun, both at once and beside phases 15-17, so each run's "
                 "steps/s and all-reduce time are read while the others share the card and "
                 "the host; seconds from the start to each one's end, imports and set-up "
                 "included): " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
                 + f"; waited for here {waited:.1f} s")

    # ---- serve what the 2 ranks trained ----
    ckpt = CheckpointManager(os.path.join(tmp, "checkpoints", "dp_diffusion", "ckpt"))
    flat = load_npz(os.path.join(ckpt.directory, str(ckpt.latest_step()), "params.npz"))
    model = GaussianDiffusion(svs.hp, vocab, svs.hp["audio_num_mel_bins"])
    load_flax_params(model, flat)
    served = SVSInferTorch(svs.hp, model, svs.pe, svs.vocoder, dev)
    reset()
    t0 = time.perf_counter()
    out = served.synthesize(make_batch(4, 16, 512, vocab, seed=9),
                            generator=torch.Generator(device=dev).manual_seed(9))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read("data parallel")
    wav = out["wav"]
    checks["2-rank weights served: audio finite"] = bool(torch.isfinite(wav).all()) and \
        tuple(wav.shape) == (4, 512 * 128)
    checks["2-rank weights served: K1-bf16 and K2-bf16 launched"] = (
        counts["fused_residual_stack_bf16"] > 0 and counts["fused_mrf_stage_bf16"] > 0)
    lines.append(f"2-rank-trained diffusion weights (step {ckpt.latest_step()}) served at B=4, "
                 f"T=512: wav {tuple(wav.shape)}, |wav| max {float(wav.abs().max()):.3f}, "
                 f"{secs:.2f} s, launches {counts}")
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


# ---- phase 15: the rest of the vocoder family ----------------------------------
def _wn_pair(sd, name, w, bias=None):
    """`w` under `name` as the reference's weight norm holds it: (weight_g,
    weight_v), v a scaled copy (torch.nn.utils.weight_norm, dim 0)."""
    w = w.detach().float().cpu()
    sd[name + ".weight_v"] = w * 1.5
    sd[name + ".weight_g"] = torch.linalg.vector_norm(w, dim=tuple(range(1, w.dim())),
                                                      keepdim=True)
    if bias is not None:
        sd[name + ".bias"] = bias.detach().float().cpu()


def reference_pwg_state_dict(gen):
    """A port ParallelWaveGANGenerator in the reference's layout
    (`modules/parallel_wavegan/models/parallel_wavegan.py`, weight norm on
    every conv): the state dict `vocoders/torch_import.py` reads."""
    sd = {}
    for ours, theirs in (("first_conv", "first_conv"), ("post_conv_1", "last_conv_layers.1"),
                         ("post_conv_2", "last_conv_layers.3"),
                         ("upsample_net.conv_in", "upsample_net.conv_in")):
        conv = gen.get_submodule(ours)
        _wn_pair(sd, theirs, conv.weight, conv.bias)
    for i in range(len(gen.scales)):
        k = getattr(gen.upsample_net.upsample, f"conv_{i}_kernel")
        _wn_pair(sd, f"upsample_net.upsample.up_layers.{2 * i + 1}", k.reshape(1, 1, 1, -1))
    for i in range(gen.layers):
        blk = getattr(gen, f"block_{i}")
        for ours, theirs in (("conv", "conv"), ("aux_conv", "conv1x1_aux"),
                             ("skip_conv", "conv1x1_skip"), ("out_conv", "conv1x1_out")):
            conv = getattr(blk, ours)
            _wn_pair(sd, f"conv_layers.{i}.{theirs}", conv.weight, conv.bias)
    return sd


def reference_melgan_state_dict(gen):
    """A port MelGanGenerator in the reference's Sequential layout
    (`melgan.*`, weight norm on every conv)."""
    sd = {}
    n = len(gen.scales)
    _wn_pair(sd, "melgan.1", gen.conv_pre.weight, gen.conv_pre.bias)
    for i in range(n):
        up = getattr(gen, f"up_{i}")
        _wn_pair(sd, f"melgan.{3 + 5 * i}", up.weight, up.bias)
        res = getattr(gen, f"res_{i}")
        for j in range(3):
            base = f"melgan.{4 + 5 * i + j}"
            for ours, theirs in ((f"conv_{j}", "stack.2"), (f"out_{j}", "stack.4"),
                                 (f"skip_{j}", "skip_layer")):
                conv = getattr(res, ours)
                _wn_pair(sd, f"{base}.{theirs}", conv.weight, conv.bias)
    _wn_pair(sd, f"melgan.{4 + 5 * n}", gen.conv_post.weight, gen.conv_post.bias)
    return sd


def _seeded_(module, seed):
    """Every weight N(0, 1 / fan-in) and bias N(0, 0.05^2), from `seed`."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.randn(p.shape, generator=g) * (fan_in ** -0.5 if p.dim() > 1 else 0.05))
    return module


def _import_round_trip(gen, state_dict_fn, importer, hp, path):
    """`gen` written in the reference's layout with torch.save, read back by
    load_torch_checkpoint and `importer` into a fresh module; returns (the
    module, the flat tree, the largest relative weight difference)."""
    from bisinger_tpu_torch.vocoders.torch_import import load_torch_checkpoint
    from bisinger_tpu_torch.weights import flatten_tree, load_flax_params

    torch.save({"state_dict": {"model_gen": state_dict_fn(gen)}}, path)
    flat = flatten_tree(importer(load_torch_checkpoint(path), hp))
    fresh = type(gen)(hp)
    load_flax_params(fresh, flat)
    worst = max(float((a.detach() - b.detach()).abs().max() / b.detach().abs().max())
                for a, b in zip(fresh.parameters(), gen.parameters()))
    return fresh.eval(), flat, worst


def vocoder_phase(svs, counters, by_path, dev, tmp, card):
    """Phase 15: the rest of the vocoder family on the card, in bf16 where a
    model has a compute dtype. (a) A Parallel WaveGAN at configs/tts/pwg.yaml's
    widths (30 layers, 3 stacks, 64/128/64 channels, aux 80, context 2) at the
    flagship's 24 kHz / hop 128 (scales 4·4·4·2): a seeded generator written
    with torch.save as the reference lays it out (weight norm), read back by
    load_torch_checkpoint + import_pwg_generator into an assets dir with its
    own config (hparams_diff.json naming the PWG) beside the flagship's
    acoustic files; from_checkpoint serves it behind diff_params.npz and the
    PE at B=4, T=512: 201 K1-bf16 launches, no K2 (`launches_by_path["pwg
    served"]`); its forward on a 32-frame mel in fp32 against the CPU,
    relative max <= 1e-4. (b) A HiFi-GAN with ResBlock2 (kernels 3, 5, 7,
    dilations 1·2, 2·6, 3·12; NSF, 512 channels) trained through
    tools/train_vocoder for 10 steps at B=8, 64 frames (no kernel in a train
    step: ResBlock2 runs as layers), and one fp32 GAN step (128 channels)
    on the card against the CPU (tools/step_parity). (c) The flagship cascade served with
    use_denoise on a score: 201 K1-bf16, 4 K2-bf16 launches
    (`launches_by_path["denoised"]`), a finite waveform that differs from the
    undenoised one. (d) MelGAN's generator (512 channels, scales 8·4·2·2,
    imported the same way), its multi-scale discriminator and both PWG
    discriminators in fp32 against the CPU, relative max <= 1e-4. `card`
    goes beside the seconds of each part. Returns (ok, lines)."""
    import contextlib

    import numpy as np

    from bisinger_tpu_torch.config import load_hparams, load_hparams_json
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch, make_batch
    from bisinger_tpu_torch.models.melgan import MelGanGenerator, MelGanMultiScaleDiscriminator
    from bisinger_tpu_torch.models.pwg import (
        ParallelWaveGANDiscriminator,
        ParallelWaveGANGenerator,
        ResidualParallelWaveGANDiscriminator,
    )
    from bisinger_tpu_torch.tools import train_vocoder
    from bisinger_tpu_torch.tools.step_parity import gan_step_parity
    from bisinger_tpu_torch.vocoders.hifigan import HifiGAN
    from bisinger_tpu_torch.vocoders.pwg import PWG
    from bisinger_tpu_torch.vocoders.torch_import import (
        import_melgan_generator,
        import_pwg_generator,
    )

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, "vocoders")
    os.makedirs(root)
    log_fn = os.path.join(repo, "checkpoints", "chip_smoke", "vocoders.log")
    lines, checks, secs = [], {}, {}
    reset, read = launch_counts(counters, by_path)
    cpu = torch.device("cpu")

    def card_vs_cpu(module, *args):
        """(relative max of the card's output against the CPU's, the output)."""
        with torch.no_grad():
            ref = module.to(cpu)(*args)
            got = module.to(dev)(*(a.to(dev) for a in args))
        flat = lambda o: torch.cat([x.reshape(-1).float().cpu() for x in (  # noqa: E731
            o if isinstance(o, (list, tuple)) else [o])])
        if isinstance(ref, list):  # the MSD: each scale's (logits, feature maps)
            ref = [x for out, feats in ref for x in [out, *feats]]
            got = [x for out, feats in got for x in [out, *feats]]
        return rel_err(flat(got), flat(ref))[1], ref

    # ---- (a) the PWG: reference checkpoint -> assets dir -> served ----
    t0 = time.perf_counter()
    flag_hp = load_hparams_json(os.path.join(FLAGSHIP_DIR, "hparams_diff.json"))
    pwg_keys = {k: v for k, v in load_hparams(os.path.join(repo, "configs", "tts", "pwg.yaml"))
                .items() if k.startswith(("pwg_", "aux_context")) or k == "vocoder"}
    voc_hp = dict(flag_hp, **pwg_keys, pwg_upsample_scales=[4, 4, 4, 2])
    gen = _seeded_(ParallelWaveGANGenerator(voc_hp), 15)
    imported, flat, w_err = _import_round_trip(gen, reference_pwg_state_dict,
                                               import_pwg_generator, voc_hp,
                                               os.path.join(root, "pwg.ckpt"))
    checks["PWG at pwg.yaml's widths"] = (imported.layers == 30 and imported.hop == 128
                                          and voc_hp["vocoder"].endswith(".PWG"))
    checks["PWG checkpoint round trip within 1e-6"] = w_err <= 1e-6
    assets = os.path.join(root, "assets")
    os.makedirs(os.path.join(assets, "vocoder"))
    for fn in ("diff_params.npz", "pe_params.npz", "pe_batch_stats.npz", "phone_set.json",
               "spk_map.json"):
        os.symlink(os.path.join(FLAGSHIP_DIR, fn), os.path.join(assets, fn))
    np.savez(os.path.join(assets, "vocoder", "generator_000000000.npz"), **flat)
    with open(os.path.join(assets, "hparams_diff.json"), "w") as f:
        json.dump(voc_hp, f)
    served = SVSInferTorch.from_checkpoint(assets, device=dev)
    checks["served through the PWG wrapper"] = isinstance(served.voc, PWG)
    vocab = served.vocab_size
    batch = make_batch(4, 16, 512, vocab, seed=15)
    served.synthesize(batch, generator=torch.Generator(device=dev).manual_seed(15))  # warm
    reset()
    t1 = time.perf_counter()
    out = served.synthesize(batch, generator=torch.Generator(device=dev).manual_seed(15))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    counts = read("pwg served")
    wav = out["wav"]
    want = {"fused_residual_stack": 0, "fused_residual_stack_bf16": 201, "fused_mrf_stage": 0,
            "fused_mrf_stage_bf16": 0}
    checks["PWG served: finite (4, 65536)"] = bool(torch.isfinite(wav).all()) and \
        tuple(wav.shape) == (4, 512 * 128)
    checks["PWG served: K1-bf16 201, no K2 launch"] = counts == want
    mel32 = out["mel"][:1, :32].float().cpu()
    z = torch.randn((1, mel32.shape[1] * 128), generator=torch.Generator().manual_seed(16))
    pwg_rel, _ = card_vs_cpu(served.vocoder, z, mel32)
    checks["PWG fp32 card vs CPU <= 1e-4"] = pwg_rel <= 1e-4
    secs["a"] = time.perf_counter() - t0
    lines.append(f"(a) PWG (pwg.yaml widths, 30 layers, hop 128) from a reference-layout "
                 f"checkpoint (torch.save, weight norm; import within {w_err:.2e} of the weights) "
                 f"served from an assets dir behind diff_params.npz and the PE at B=4, T=512: "
                 f"wav {tuple(wav.shape)}, |wav| max {float(wav.abs().max()):.3f}, warm "
                 f"{serve_s:.3f} s, launches {counts}; PWG fp32 card vs CPU (32 frames) "
                 f"relative max {pwg_rel:.3e} (tol 1e-4); {secs['a']:.1f} s")
    del served, out, wav

    # ---- (b) ResBlock2 HiFi-GAN: train_vocoder, then a fp32 GAN step card vs CPU ----
    t0 = time.perf_counter()
    rb2 = dict(resblock="2", resblock_kernel_sizes=[3, 5, 7],
               resblock_dilation_sizes=[[1, 2], [2, 6], [3, 12]])
    cfg_fn = os.path.join(root, "resblock2.json")
    with open(cfg_fn, "w") as f:
        json.dump(rb2, f)
    per_step = []
    voc_cfg = dict(train_vocoder.settings(), steps=TRAIN_STEPS, batch=8, frames=64,
                   channels=512, multiband=1, out_dir=os.path.join(root, "rb2"), config=cfg_fn)
    reset()
    with open(log_fn, "w") as logf, contextlib.redirect_stderr(logf):
        summary = train_vocoder.run(voc_cfg, device=dev, on_step=lambda s, m: per_step.append(
            {k: c.launches for k, c in counters.items()}))
    if per_step:
        by_path["15 train resblock2 vocoder"] = per_step[-1]
    checks[f"ResBlock2 vocoder {TRAIN_STEPS} steps"] = len(per_step) == TRAIN_STEPS
    checks["ResBlock2 vocoder losses finite, gen_mel fell"] = bool(np.isfinite([
        summary.get(k, np.nan) for k in ("gen_mel_first", "gen_mel_last", "disc_loss_first",
                                         "disc_loss_last")]).all()) and \
        summary["gen_mel_last"] < summary["gen_mel_first"]
    checks["ResBlock2 vocoder: no kernel launched in any train step"] = all(
        not any(n.values()) for n in per_step)
    # the parity step at 128 channels, the same layers: at 512 its CPU steps take ~25 s
    hp32 = load_hparams(cfg_fn, dict(compute_dtype="float32", upsample_initial_channel=128))
    ok, gtext = gan_step_parity(hp32, dev, reference_device=None)  # GAN_REFERENCE
    checks["ResBlock2 GAN fp32 step card vs CPU"] = ok
    checks["no kernel launched in the parity step"] = not any(read("15 parity").values())
    secs["b"] = time.perf_counter() - t0
    lines.append(f"(b) HiFi-GAN with ResBlock2 (kernels 3·5·7, dilations 1·2 2·6 3·12, NSF, 512 "
                 f"channels, B=8, 64 frames, bf16) through tools/train_vocoder: "
                 f"{summary.get('steps_per_s', np.nan):.2f} steps/s (first step apart); gen_mel "
                 f"{summary.get('gen_mel_first', np.nan):.4f} -> "
                 f"{summary.get('gen_mel_last', np.nan):.4f}; disc_loss "
                 f"{summary.get('disc_loss_first', np.nan):.4f} -> "
                 f"{summary.get('disc_loss_last', np.nan):.4f}; fp32 GAN step card vs CPU "
                 f"(128 channels, B=2, 32 frames): {gtext}; {secs['b']:.1f} s")

    # ---- (c) the flagship cascade with use_denoise ----
    t0 = time.perf_counter()
    svs_d = copy.copy(svs)
    svs_d.voc = HifiGAN(dict(svs.voc.hp, use_denoise=True), device=dev, model=svs.vocoder)
    svs.infer_batch([SCORES[0]])  # warm
    reset()
    wav_d = svs_d.infer_batch([SCORES[0]])[0]
    torch.cuda.synchronize()
    counts_d = read("denoised")
    wav_p = svs.infer_batch([SCORES[0]])[0]
    want_d = dict(want, fused_mrf_stage_bf16=4)
    checks["denoised: K1-bf16 201, K2-bf16 4"] = counts_d == want_d
    checks["denoised: finite, differs from the plain waveform"] = (
        bool(np.isfinite(wav_d).all()) and wav_d.shape == wav_p.shape
        and float(np.abs(wav_d - wav_p).max()) > 1e-4)
    secs["c"] = time.perf_counter() - t0
    lines.append(f"(c) flagship cascade with use_denoise (denoise_v 0.002) on a score: "
                 f"{len(wav_d)} samples, |denoised - plain| max "
                 f"{float(np.abs(wav_d - wav_p).max()):.4f}, launches {counts_d}; "
                 f"{secs['c']:.1f} s")

    # ---- (d) MelGAN and the discriminators, fp32 card vs CPU ----
    t0 = time.perf_counter()
    mel_hp = dict(flag_hp, melgan_upsample_scales=[8, 4, 2, 2], melgan_channels=512)
    mg = _seeded_(MelGanGenerator(mel_hp), 17)
    mg, _, mg_err = _import_round_trip(mg, reference_melgan_state_dict,
                                       import_melgan_generator, mel_hp,
                                       os.path.join(root, "melgan.ckpt"))
    checks["MelGAN checkpoint round trip within 1e-6"] = mg_err <= 1e-6
    mel_in = mel32 * 0.5
    rels = {"MelGAN generator": card_vs_cpu(mg, mel_in)}
    wave = rels["MelGAN generator"][1]
    reset()
    for name, module in (("MelGAN MSD", MelGanMultiScaleDiscriminator()),
                         ("PWG discriminator", ParallelWaveGANDiscriminator()),
                         ("residual PWG discriminator", ResidualParallelWaveGANDiscriminator())):
        rels[name] = card_vs_cpu(_seeded_(module, 18), wave)
    checks["no kernel launched by MelGAN or the discriminators"] = not any(
        read("15 melgan and discriminators").values())
    for name, (rel, _) in rels.items():
        checks[f"{name} fp32 card vs CPU <= 1e-4"] = rel <= 1e-4
    secs["d"] = time.perf_counter() - t0
    lines.append(f"(d) fp32 card vs CPU, relative max (tol 1e-4): " + ", ".join(
        f"{name} {rel:.3e}" for name, (rel, _) in rels.items())
                 + f" (MelGAN 512 channels, 8·4·2·2, imported within {mg_err:.2e}; "
                 f"{wave.shape[-1]} samples); {secs['d']:.1f} s")
    lines.append(f"seconds by part on {card}: " + json.dumps(
        {k: round(v, 2) for k, v in secs.items()}))
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


# ---- phase 16: the BiSinger paper's recipe -----------------------------------
PAPER_STEPS = 5  # cut from 10 to keep the smoke under its 600 s gate
PAPER_M4_ITEMS = 64
PAPER_DB4_ITEMS = 32
PAPER_NUS_ITEMS = 32
# the DB-4 stand-in: Mandarin speech aligned in the CMU phones of its pinyin
# (data/text/pinyin.py, the convention of the recipe's MFA lexicon)
DB4_SYLLABLES = ("ai", "de", "hao", "li", "ma", "ni", "qing", "shang", "wo", "wu", "xin", "yang")
# the synthetic songs are "<singer>#song<i % 3>": configs/usr/m4singer's own
# held-out songs match none of them, so these hold 4 items out
M4_TEST_PREFIXES = ["Alto-1#song0#000", "Tenor-1#song1#000"]
# a bilingual score: pinyin, and an English word whose phones the EN->CN
# tables of systems 1 and 2 rewrite (yeah: Y AE -> IY AE)
PAPER_SCORE = dict(item_name="paper", text="SP hao xin yeah ma SP",
                   notes="rest | C4 | D4 | E4 | G4 | rest",
                   notes_duration="0.15 | 0.3 | 0.3 | 0.4 | 0.3 | 0.15")
# (meta, config, overrides) of each system's two stages in training order; the
# work dirs are <meta>_fs2 and <meta>_diff, the second warm-started from the
# first. les-m4-nus/diff.yaml names its diffusion task itself: its second base
# (./base.yaml) merges the FFT-Singer's task_cls back over the first's, in JAX's
# cascade and in the port's (ROADMAP Queue 3, fault 6)
PAPER_RUNS = (("system1", "usr/m4singer/fs2.yaml", ""),
              ("system1", "usr/m4singer/system1.yaml", ""),
              ("system2", "usr/m4singer/fs2.yaml", ""),
              ("system2", "usr/m4singer/system2.yaml", ""),
              ("les", "usr/les-m4-nus/fs2.yaml", ""),
              ("les", "usr/les-m4-nus/diff.yaml",
               ",task_cls=bisinger_tpu.training.tasks.DiffSingerMIDITask"))


def m4_textgrids(item, r):
    """An original M4Singer item -> (its M4Singer TextGrid, its MFA TextGrid),
    the two that tools/proportional reads, from the item's own durations: a
    phone interval for each slur group (M4Singer's pinyin initials and
    finals), a word for each initial + final pair or lone group; the MFA
    grid has the same words, each group's time shared by its CMU phones in
    ratios drawn from `r` (a numpy RandomState), as an aligner places them."""
    import numpy as np

    from bisinger_tpu_torch.data.text.pinyin import FINALS, INITIALS
    from bisinger_tpu_torch.tools.meta import slur_runs

    groups = slur_runs(item["is_slur"])
    phs = [item["phs"][g[0]] for g in groups]
    bounds = [0.0]
    for g in groups:
        bounds.append(bounds[-1] + sum(item["ph_dur"][i] for i in g))
    words, k = [], 0  # (first group, last group, pinyin; "" for a silence)
    while k < len(groups):
        if phs[k] in INITIALS and k + 1 < len(groups) and phs[k + 1] in FINALS:
            words.append((k, k + 1, phs[k] + phs[k + 1]))
            k += 2
        else:
            words.append((k, k, "" if phs[k] in ("<SP>", "<AP>") else phs[k]))
            k += 1
    mfa_phones = []
    for a, b, text in words:
        if not text:
            mfa_phones.append((bounds[a], bounds[b + 1], ""))
            continue
        for g in range(a, b + 1):
            cmu = INITIALS.get(phs[g]) or FINALS[phs[g]]
            cuts = np.cumsum(r.uniform(0.5, 1.5, len(cmu)))
            edges = ([bounds[g]] + [bounds[g] + (bounds[g + 1] - bounds[g]) * c / cuts[-1]
                                    for c in cuts[:-1]] + [bounds[g + 1]])
            mfa_phones += list(zip(edges[:-1], edges[1:], cmu))
    m4 = textgrid_text(bounds[-1], [
        ("words", [(bounds[a], bounds[b + 1], text or "<SP>") for a, b, text in words]),
        ("phones", [(bounds[g], bounds[g + 1], ph) for g, ph in enumerate(phs)])])
    mfa = textgrid_text(bounds[-1], [
        ("words", [(bounds[a], bounds[b + 1], text) for a, b, text in words]),
        ("phones", mfa_phones)])
    return m4, mfa


def paper_corpora(root, n_m4=PAPER_M4_ITEMS, n_db4=PAPER_DB4_ITEMS, n_nus=PAPER_NUS_ITEMS,
                  seed=0):
    """Phase 16 (a): the port's corpus tools on the host, as the paper's
    recipe runs them. An M4Singer corpus in its original layout (synthetic,
    fmt "m4_original": pinyin phones, no word boundary or lang; its meta the
    JSON list M4Singer ships) -> system 1's meta by `python -m
    bisinger_tpu_torch.tools.meta`; its M4Singer and MFA TextGrids
    (`m4_textgrids`) -> system 2's meta by tools.proportional.pipeline; a
    DB-4 speech set (wav and TextGrid pairs, `write_textgrid_corpus` over
    DB4_SYLLABLES) -> tools.db4_meta.extract_corpus ->
    tools.pitch_shift.shift_meta_file, and tools.mfa_prep.prepare_corpus on
    its wavs; a bilingual singing set (the synthetic BiSinger-format corpus
    under NUS-48E's singer names) merged with the DB-4 and the shifted metas
    by tools.merge.merge_meta_jsons. pyworld is absent on the card's
    machine, so each shifted item's wav is a copy of its speech wav, the
    file the resynthesis would write. Returns (metas {system1, system2, les:
    (raw_data_dir, raw_json_fn)}, lines, checks)."""
    import shutil

    import numpy as np

    from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
    from bisinger_tpu_torch.data.text.pinyin import pinyin_to_cmu
    from bisinger_tpu_torch.tools import db4_meta, merge, mfa_prep, pitch_shift, proportional

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    lines, checks, t0 = [], {}, time.perf_counter()

    # M4Singer, original layout -> system 1 (even split) and system 2 (MFA ratios)
    m4 = os.path.join(root, "m4")
    make_synthetic_corpus(m4, n_items=n_m4, seed=seed, fmt="m4_original")
    with open(os.path.join(m4, "meta.json"), encoding="utf-8") as f:
        original = [json.loads(ln) for ln in f if ln.strip()]
    with open(os.path.join(m4, "meta_list.json"), "w", encoding="utf-8") as f:
        json.dump(original, f, ensure_ascii=False)
    proc = subprocess.run([sys.executable, "-m", "bisinger_tpu_torch.tools.meta",
                           os.path.join(m4, "meta_list.json"),
                           os.path.join(m4, "meta_system1.json")],
                          env=env, capture_output=True, text=True, timeout=120)
    checks["tools.meta rc 0"] = proc.returncode == 0
    lines.append(f"python -m bisinger_tpu_torch.tools.meta: "
                 f"{proc.stdout.strip() or proc.stderr[-500:]}")
    r = np.random.RandomState(seed)
    for item in original:
        singer, song, sent = item["item_name"].split("#")
        m4_tg, mfa_tg = m4_textgrids(item, r)
        for path, text in ((os.path.join(m4, "tg_m4", f"{singer}#{song}", f"{sent}.TextGrid"),
                            m4_tg),
                           (os.path.join(m4, "tg_mfa", singer, f"{song}#{sent}.TextGrid"),
                            mfa_tg)):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                f.write(text)
    ok, failed = proportional.pipeline(os.path.join(m4, "meta.json"),
                                       os.path.join(m4, "meta_system2.json"),
                                       os.path.join(m4, "tg_m4"), os.path.join(m4, "tg_mfa"))
    checks[f"tools.proportional: {n_m4} items, none skipped"] = (ok, failed) == (n_m4, 0)
    lines.append(f"tools.proportional.pipeline: {ok} written, {failed} skipped")

    # DB-4 speech -> meta -> pitch-shifted pseudo-singing; MFA's corpus layout
    les = os.path.join(root, "les")
    db4_dir = os.path.join(les, "db4#cn")
    corpus = write_textgrid_corpus(db4_dir, n_db4, seed=seed + 1, sample_rate=24000,
                                   dur_range=(1.5, 3.0), prefix="DB",
                                   lexicon={s: pinyin_to_cmu(s) for s in DB4_SYLLABLES})
    transcripts = {m["item_name"]: m["txt"] for m in corpus}
    db4_fn, shift_fn = os.path.join(les, "meta_db4.json"), os.path.join(les, "meta_shift.json")
    n = db4_meta.extract_corpus(db4_dir, db4_dir, db4_fn, lang=1, singer="db4", song="cn",
                                transcripts=transcripts)
    n_shift = pitch_shift.shift_meta_file(db4_fn, shift_fn)
    try:
        pitch_shift.shift_item_audio(np.zeros(2400, np.float32), 24000, [0.1], [220.0])
        resynth = "pyworld present, not used"
    except RuntimeError as e:
        resynth = f"shift_item_audio: {e}"
    os.makedirs(os.path.join(les, "db4#cn-shift"))
    for item_id in transcripts:
        shutil.copy(os.path.join(db4_dir, f"{item_id}.wav"),
                    os.path.join(les, "db4#cn-shift", f"{item_id}.wav"))
    n_mfa = mfa_prep.prepare_corpus(db4_dir, transcripts, os.path.join(root, "mfa_db4"), "db4")
    checks[f"db4: {n_db4} extracted, shifted and paired for MFA"] = n == n_shift == n_mfa == n_db4
    lines.append(f"db4: extract_corpus {n} items, shift_meta_file {n_shift}, the shifted "
                 f"items' wavs copies of the speech wavs ({resynth}), prepare_corpus {n_mfa} "
                 "wav/lab pairs")

    # the bilingual singing set, merged with the speech and the pseudo-singing
    nus_fn = make_synthetic_corpus(les, n_items=n_nus, seed=seed + 2, json_fn="meta_nus.json",
                                   singers=["ADIZ", "JLEE"])
    n_les = merge.merge_meta_jsons([nus_fn, db4_fn, shift_fn],
                                   os.path.join(les, "meta_les-m4-nus.json"))
    metas = {"system1": (m4, "meta_system1.json"), "system2": (m4, "meta_system2.json"),
             "les": (les, "meta_les-m4-nus.json")}
    by_name = {o["item_name"]: o for o in original}
    tags = set()
    for name, (raw, fn) in metas.items():
        with open(os.path.join(raw, fn), encoding="utf-8") as f:
            items = [json.loads(ln) for ln in f if ln.strip()]
        checks[f"{name}: {len(items)} items"] = len(items) == (
            n_nus + 2 * n_db4 if name == "les" else n_m4)
        checks[f"{name}: phs, notes, ph_dur of one length"] = all(
            len(it["phs"]) == len(it["notes"]) == len(it["ph_dur"]) for it in items)
        if name == "les":
            tags = {it["speechsing"] for it in items}
        else:  # a conversion keeps each item's length
            checks[f"{name}: durations kept"] = all(
                abs(sum(it["ph_dur"]) - sum(by_name[it["item_name"]]["ph_dur"])) < 5e-3
                for it in items)
    checks["speechsing tags 0, 1, 2 after the merge"] = tags == {0, 1, 2}
    lines.append(f"tools.merge: {n_les} items, speechsing tags {sorted(tags)}; the tools "
                 f"{time.perf_counter() - t0:.1f} s")
    return metas, lines, checks


def paper_phase(counters, by_path, dev, tmp, card, prep):
    """Phase 16: the BiSinger paper's recipe. (a) `paper_corpora`: the corpus
    tools write system 1's, system 2's and the merged les-m4-nus meta. (b)
    Each meta binarized (these two in the background, `prep_paper`) by `run --binarize` with its config's binarizer
    (M4SingerBinarizer; the three at once, 3 processes each), then the
    paper's systems trained from their own YAML in bf16 at the configs'
    widths and max_tokens, only the steps cut (PAPER_STEPS a stage): the
    monolingual FastSpeech2MIDI (configs/usr/m4singer/fs2.yaml: no ESM,
    lang or style embedding) and system1.yaml warm-started from it on
    system 1's meta, the same two with system2.yaml on system 2's meta, and
    les-m4-nus/fs2.yaml then diff.yaml on the merged meta (num_spk 20).
    Gates: every meta's phones in its binarized phone set, finite losses, no
    kernel launched in training, the warm starts, no esm/, lang_embed or
    style_embed key in a monolingual checkpoint. (c) Each diffusion work
    dir serves PAPER_SCORE through `run --infer` in bf16 with the flagship's
    vocoder (artifacts/flagship) and the model's own f0 (the configs set
    pe_enable and no pe_ckpt: a warning, as JAX): 201 K1-bf16 and 4 K2-bf16 launches
    a request, a finite waveform of whole 128-sample frames; for systems 1
    and 2 the English word's phones hold no key of the system's
    EN_PHONE_SUBST table and hold the phones it substitutes. `card` goes
    beside the times. Returns (ok, lines)."""
    import contextlib

    import numpy as np

    from bisinger_tpu_torch import run
    from bisinger_tpu_torch.config import load_hparams_json
    from bisinger_tpu_torch.data.text.frontend import ENGLISH, EN_PHONE_SUBST, BilingualFrontend
    from bisinger_tpu_torch.inference import pipeline
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.utils.text_encoder import build_phone_encoder
    from bisinger_tpu_torch.weights import load_npz

    repo = os.path.dirname(os.path.abspath(__file__))
    log_fn = os.path.join(repo, "checkpoints", "chip_smoke", "paper.log")
    root = os.path.join(tmp, "paper")
    reset, read = launch_counts(counters, by_path)
    t_phase = time.perf_counter()
    # ---- (a) the tools and (b) the three binarizations (`prep_paper`) ----
    res = prep.wait("paper")
    cwd = os.getcwd()
    try:
        os.chdir(root)
        metas = {name: tuple(v) for name, v in res["metas"].items()}
        lines, checks, outs, stats = res["lines"], res["checks"], res["outs"], {}
        data = paper_data(root, metas)
        with open(log_fn, "w") as f:
            f.write("".join(outs.values()))
        for name, rc in res["rcs"].items():
            checks[f"binarize {name} rc 0"] = rc == 0
            if rc != 0:
                return False, lines + [f"binarize {name} failed: {outs[name][-2000:]}"]
            raw, fn = metas[name]
            with open(os.path.join(raw, fn), encoding="utf-8") as f:
                phones = {ph for ln in f if ln.strip() for ph in json.loads(ln)["phs"]}
            with open(os.path.join(root, f"bin_{name}", "phone_set.json")) as f:
                checks[f"{name}: every phone in the binarized phone set"] = phones <= set(
                    json.load(f))
        counts_lines = {name: "; ".join(ln[2:] for ln in out.splitlines()
                                         if ln.startswith("| binarized"))
                        for name, out in outs.items()}
        lines.append(f"binarize (M4SingerBinarizer, 3 runs at once, 3 processes each): "
                     f"{res['binarize_s']:.1f} s{prep.when(res)} ({json.dumps(counts_lines)})")
        stats["binarize"] = dict(seconds=res["binarize_s"])

        common = "log_interval=1,val_check_interval=1000,num_ckpt_keep=2"
        for meta, config, over in PAPER_RUNS:
            stage1 = config.endswith("/fs2.yaml")
            name = f"{meta}_{'fs2' if stage1 else 'diff'}"
            fs2_dir = os.path.join(root, "checkpoints", f"{meta}_fs2")
            extra = over + ("" if stage1 else f",fs2_ckpt={fs2_dir}")
            tr = run.trainer_from_args(run.parse_args(
                ["--config", os.path.join(repo, "configs", config), "--exp_name", name,
                 "--hparams", f"{data[meta]},{common},max_updates={PAPER_STEPS}{extra}"]))
            torch.cuda.reset_peak_memory_stats()
            reset()
            with open(log_fn, "a") as logf, contextlib.redirect_stdout(logf):
                tr.fit()
            counts = read(f"16 train {name}")
            log = tr.train_log
            t1, tn = log[0][1], log[-1][1]
            hp = tr.task.hp
            st = stats[name] = dict(
                first_s=t1 - tr.loop_started, steps_per_s=(len(log) - 1) / (tn - t1),
                mem=torch.cuda.max_memory_allocated() / 2 ** 30,
                loss1=log[0][2]["total_loss"], loss_last=log[-1][2]["total_loss"])
            checks[f"{name} losses finite"] = all(
                np.isfinite(v) for _, _, m in log for v in m.values())
            checks[f"{name} {PAPER_STEPS} steps"] = tr.global_step == PAPER_STEPS
            checks[f"{name} no kernel launched in training"] = not any(counts.values())
            ckpt = CheckpointManager(os.path.join(root, "checkpoints", name, "ckpt"))
            keys = load_npz(os.path.join(ckpt.directory, str(ckpt.latest_step()),
                                         "params.npz"))
            lang_keys = [k for k in keys if k.split("/")[0 if stage1 else 1]
                         in ("esm", "lang_embed", "style_embed")]
            if meta == "les":
                checks[f"{name} has the ESM, lang and style embeddings"] = bool(lang_keys)
            else:
                checks[f"{name}: no esm/, lang_embed or style_embed key"] = not lang_keys
            if not stage1:
                with open(log_fn) as f:
                    checks[f"{name} warm-started from {os.path.basename(fs2_dir)}"] = (
                        f"| warm-started fs2 from {fs2_dir}" in f.read())
            lines.append(
                f"{name} ({config}: {hp['task_cls'].rsplit('.', 1)[-1]}, use_lang_embed "
                f"{hp['use_lang_embed']}, hidden {hp['hidden_size']}, {hp['enc_layers']} + "
                f"{hp['dec_layers']} FFT layers, "
                + (f"DiffNet {hp['residual_layers']} x {hp['residual_channels']}, "
                   if not stage1 else "")
                + f"max_tokens {hp['max_tokens']}, num_spk {hp['num_spk']}, bf16): first step "
                f"{st['first_s']:.2f} s, then {st['steps_per_s']:.2f} steps/s; peak memory "
                f"{st['mem']:.2f} GiB; loss step 1 {st['loss1']:.4f}, step {PAPER_STEPS} "
                f"{st['loss_last']:.4f}; {len(keys)} parameter arrays")

        # ---- (c) serve the bilingual score from each diffusion work dir ----
        req_fn = os.path.join(root, "score.json")
        with open(req_fn, "w") as f:
            json.dump([PAPER_SCORE], f)
        want = {"fused_residual_stack": 0, "fused_residual_stack_bf16": 201,
                "fused_mrf_stage": 0, "fused_mrf_stage_bf16": 4}
        written = {}
        save_wav = pipeline.save_wav

        def keep(wav, path, sr, **kw):  # the float waveform behind the 16-bit file
            written[path] = np.array(wav, np.float32)
            return save_wav(wav, path, sr, **kw)

        for meta in metas:
            name = f"{meta}_diff"
            hp = load_hparams_json(os.path.join(root, "checkpoints", name, "config.json"))
            encoder = build_phone_encoder(hp["binary_data_dir"])
            ret = BilingualFrontend(encoder, phone_subst=hp.get("en_phone_subst")
                                    ).preprocess_word_level(PAPER_SCORE)
            raw = BilingualFrontend(encoder).preprocess_word_level(PAPER_SCORE)
            raw_en = [ph for ph, lg in zip(raw["ph_seq"].split(), raw["lang"]) if lg == ENGLISH]
            served_en = [ph for ph, lg in zip(ret["ph_seq"].split(), ret["lang"])
                         if lg == ENGLISH]
            table = EN_PHONE_SUBST.get(hp.get("en_phone_subst"), {})
            if table:
                subst = {table[ph] for ph in raw_en if ph in table}
                checks[f"{name}: English phones {served_en} hold no key of "
                       f"{hp['en_phone_subst']}'s table and hold {sorted(subst)}"] = (
                    bool(subst) and not set(served_en) & set(table) and subst <= set(served_en))
            checks[f"{name}: every served phone in its phone set"] = all(
                i != encoder.unk_index for i in encoder.encode(ret["ph_seq"]))
            out_dir = os.path.join(root, f"out_{name}")
            pipeline.save_wav = keep
            reset()
            t0 = time.perf_counter()
            try:
                with open(log_fn, "a") as logf, contextlib.redirect_stdout(logf):
                    rc = run.main(["--infer", "--exp_name", name, "--input", req_fn,
                                   "--out", out_dir, "--device", "cuda"])
            finally:
                pipeline.save_wav = save_wav
            serve_s = time.perf_counter() - t0
            counts = read(f"16 served {name}")
            wav = written.get(os.path.join(out_dir, "paper.wav"), np.zeros(0, np.float32))
            checks[f"{name} run --infer rc 0"] = rc == 0
            checks[f"{name} served: K1-bf16 201, K2-bf16 4, fp32 0 launches"] = counts == want
            checks[f"{name} served: finite, non-silent, whole 128-sample frames"] = (
                len(wav) > 0 and bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 1e-3
                and len(wav) % 128 == 0)
            stats[f"{name} served"] = dict(seconds=serve_s, audio_s=len(wav) / 24000)
            lines.append(f"{name} served through run --infer (en_phone_subst "
                         f"{hp.get('en_phone_subst')}; phones {ret['ph_seq']}): {len(wav)} "
                         f"samples, |wav| max {float(np.abs(wav).max(initial=0)):.3f}, "
                         f"{serve_s:.2f} s with the loading, launches {counts}")
        lines.append(f"binarize s, steps/s (first step apart), peak GiB, losses, served s on "
                     f"{card}: " + json.dumps({k: {kk: round(vv, 4) for kk, vv in v.items()}
                                               for k, v in stats.items()}))
        lines.append(f"phase 16 {time.perf_counter() - t_phase:.1f} s, and its host part ((a) "
                     f"and the binarizations) {res['ended'] - res['started']:.1f} s in the "
                     "background")
    finally:
        os.chdir(cwd)
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


# ---- phase 17: the model and data variants ----------------------------------------
VARIANT_STEPS = 5  # cut from 10 to keep the smoke under its 600 s gate
# (a) the speech variant: a CRF duration head, speaker vectors, causal relu FFNs and
# the energy embedding under the log10 energy convention (10**mel)
SPEECH_VARIANT = ("dur_loss=crf,use_spk_embed=true,ffn_padding=LEFT,ffn_act=relu,"
                  "use_energy_embed=true,energy_convention=pow10")
# (b) the singing variant: the mixture duration head, split speaker ids, ESPnet's
# relative positions, swish FFNs
SING_VARIANT = "dur_loss=mog,use_split_spk_id=true,rel_pos=true,ffn_act=swish"
VARIANT_SCORE = dict(  # phoneme level, bilingual: the synthetic corpus's phones (lang 1 English)
    item_name="variant", input_type="phoneme", spk_name="Alto-1",
    ph_seq="<SP> sh ang HH AH L OW x in <SP>",
    note_seq="rest C4 C4 D4 D4 E4 E4 G4 G4 rest",
    note_dur_seq="0.1 0.15 0.15 0.15 0.15 0.15 0.15 0.2 0.2 0.1",
    is_slur_seq=" ".join(["0"] * 10), lang_seq="0 0 0 1 1 1 1 0 0 0")


def variant_data(tmp):
    """Phase 17's data keys: (a) phase 13's TextGrid corpus binarized with
    speaker vectors and loudness normalisation; (b) phase 10's corpus with
    the long silences trimmed."""
    root = os.path.join(tmp, "variants")
    return dict(
        speech=(f"raw_data_dir={tmp}/tts/raw,raw_json_fn=meta.json,binary_data_dir={root}/"
                "speech_bin,binarization_args.with_spk_embed=true,loud_norm=true"),
        sing=(f"raw_data_dir={tmp}/raw,binary_data_dir={root}/sing_bin,"
              "binarization_args.trim_long_sil=true"))


def variants_phase(counters, by_path, dev, tmp, card, prep):
    """Phase 17: the model and data variants trained and served on the card
    in bf16 at the configs' widths and batching, only the steps cut
    (VARIANT_STEPS a stage). (a) Phase 13's TextGrid corpus binarized with
    speaker vectors (`with_spk_embed`) and `loud_norm`; lj/fs2 and then
    lj_ds_beta6 (warm-started from it) with SPEECH_VARIANT; one request with a
    corpus speaker's vector served from the DiffSpeech work dir and phase
    13's assets dir: 16 K1-bf16, 4 K2-bf16 launches. (b) Phase 10's corpus
    binarized with `trim_long_sil`; the FFT-Singer and diffusion stages of
    the flagship (hparams_fs2.json, hparams_diff.json, B=48, 512 frames) with
    SING_VARIANT, the second warm-started from the first; a PitchExtractor
    with LEFT convs and `pitch_norm: standard` (f0_mean and f0_std the
    corpus's); VARIANT_SCORE served from the diffusion work dir with that PE
    run as its pe_ckpt (its weights in a PE of the diffusion run's config, as
    JAX builds it) and the flagship's vocoder: 201 K1-bf16, 4 K2-bf16; the
    PE in its own config on the served mel. (c) The flagship's diffusion
    stage with the FFT denoiser (`diff_decoder_type: fft`, warm-started from
    diff_params.npz); VARIANT_SCORE served with the flagship's vocoder and the
    model's own f0 (pe_enable without a pe_ckpt): no K1 launch, 4 K2-bf16.
    Gates: finite losses,
    non-zero gradients (the encoder's and the denoiser's; every PE
    parameter's), no kernel launched in any train step, the launch counts of
    each served request (counters zeroed just before it), finite non-silent
    waveforms, one fp32 step of each variant task on the card against the CPU
    (tools/step_parity), webrtcvad absent (the trim takes the energy VAD).
    `card` goes beside the times. Returns (ok, lines)."""
    import contextlib
    import importlib.util

    import numpy as np

    from bisinger_tpu_torch import run
    from bisinger_tpu_torch.config import apply_overrides, load_hparams, load_hparams_json
    from bisinger_tpu_torch.data.dataset import DataLoader, M4SingerDataset, batch_to_device
    from bisinger_tpu_torch.data.records import RecordReader
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch, make_batch
    from bisinger_tpu_torch.tools.step_parity import step_parity
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.training.tasks import (
        AuxDecoderMIDITask,
        DiffSingerMIDITask,
        PitchExtractionTask,
    )
    from bisinger_tpu_torch.weights import load_npz

    repo = os.path.dirname(os.path.abspath(__file__))
    cfg = {name: os.path.join(repo, "configs", path) for name, path in (
        ("lj_fs2", "tts/lj/fs2.yaml"), ("lj_ds_beta6", "usr/lj_ds_beta6.yaml"))}
    cfg.update(fs2=os.path.join(tmp, "fs2.json"), diff=os.path.join(tmp, "diff.json"))
    log_fn = os.path.join(repo, "checkpoints", "chip_smoke", "variants.log")
    root = os.path.join(tmp, "variants")
    data = variant_data(tmp)
    lines, checks, stats = [], {}, {}
    reset, read = launch_counts(counters, by_path)
    t_phase = time.perf_counter()
    res = prep.wait("variants")  # the two binarizations (`prep_variants`)
    cwd = os.getcwd()
    try:
        os.chdir(root)
        with open(log_fn, "w") as f:
            f.write("".join(r["stdout"] + r["stderr"] for r in res["runs"].values()))
        labels = {"speech": " (a) (TextGridBinarizer, with_spk_embed, loud_norm)",
                  "sing": " (b) (M4SingerBinarizer, trim_long_sil)"}
        for name, r in res["runs"].items():
            checks[f"binarize {name} rc 0"] = r["rc"] == 0
            if r["rc"] != 0:
                return False, [f"binarize {name} failed: {r['stderr'][-2000:]}"]
            lines.append(prep.binarize_line(dict(r, started=res["started"], ended=res["ended"],
                                                 waited_s=res["waited_s"]), labels[name], 4))
        checks["webrtcvad absent: the trim takes the energy VAD"] = (
            importlib.util.find_spec("webrtcvad") is None)
        speech_item = RecordReader(os.path.join(root, "speech_bin", "train"))[0]
        checks["speaker vectors binarized (256, unit norm)"] = (
            speech_item["spk_embed"].shape == (256,)
            and abs(float(np.linalg.norm(speech_item["spk_embed"])) - 1.0) < 1e-5)
        sing_hp = load_hparams_json(cfg["fs2"], data["sing"])
        trimmed = float(sum(np.load(os.path.join(root, "sing_bin", f"{s}_lengths.npy")).sum()
                            for s in ("train", "test")))
        untrimmed = float(sum(np.load(os.path.join(tmp, "binary", f"{s}_lengths.npy")).sum()
                              for s in ("train", "test")))
        lines.append(f"the trim: {trimmed:.0f} frames of {untrimmed:.0f} kept "
                     f"({sing_hp['hop_size']}-sample frames)")
        checks["trimmed corpus no longer than the untrimmed"] = trimmed <= untrimmed

        def train(name, config, extra):
            """`config` for VARIANT_STEPS steps in work dir `name`: the trainer."""
            tr = run.trainer_from_args(run.parse_args(
                ["--config", config, "--exp_name", name, "--hparams",
                 f"{extra},max_updates={VARIANT_STEPS},log_interval=1,val_check_interval=1000,"
                 "num_ckpt_keep=2"]))
            grads = {}

            def on_step(step, metrics):
                if step <= 2:  # a DiffNet's zero output projection passes no gradient at step 1
                    grads[step] = _grad_checks(tr.task.model)

            torch.cuda.reset_peak_memory_stats()
            reset()
            with open(log_fn, "a") as logf, contextlib.redirect_stdout(logf):
                tr.fit(on_step=on_step)
            counts = read(f"17 train {name}")
            log = tr.train_log
            t1, tn = log[0][1], log[-1][1]
            hp = tr.task.hp
            st = stats[name] = dict(first_s=t1 - tr.loop_started,
                                    steps_per_s=(len(log) - 1) / (tn - t1),
                                    mem=torch.cuda.max_memory_allocated() / 2 ** 30,
                                    loss1=log[0][2]["total_loss"],
                                    loss_last=log[-1][2]["total_loss"])
            checks[f"{name} losses finite"] = all(
                np.isfinite(v) for _, _, m in log for v in m.values())
            checks[f"{name} grads finite, encoder's and denoiser's non-zero"] = (
                all(g[0] for g in grads.values()) and grads[2][1])
            checks[f"{name} {VARIANT_STEPS} steps"] = tr.global_step == VARIANT_STEPS
            checks[f"{name} no kernel launched in training"] = not any(counts.values())
            lines.append(
                f"{name} ({hp['task_cls'].rsplit('.', 1)[-1]}; dur_loss {hp['dur_loss']}, "
                f"use_spk_embed {hp['use_spk_embed']}, use_split_spk_id "
                f"{hp['use_split_spk_id']}, rel_pos {hp['rel_pos']}, ffn "
                f"{hp['ffn_padding']}/{hp['ffn_act']}, diff_decoder_type "
                f"{hp.get('diff_decoder_type')}; hidden {hp['hidden_size']}, bf16): first step "
                f"{st['first_s']:.2f} s, then {st['steps_per_s']:.2f} steps/s; peak memory "
                f"{st['mem']:.2f} GiB; loss step 1 {st['loss1']:.4f}, step {VARIANT_STEPS} "
                f"{st['loss_last']:.4f}; launches {counts}")
            return tr

        def serve(label, svs, request, want):
            """One warm request, then `request` timed with the counters zeroed."""
            svs.infer_once(request)
            reset()
            t0 = time.perf_counter()
            wav = svs.infer_once(request)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read(f"17 served {label}")
            hop = svs.hp["hop_size"]
            checks[f"{label} served: finite, non-silent, whole {hop}-sample frames"] = (
                bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 1e-3
                and len(wav) % hop == 0)
            checks[f"{label} served: K1-bf16 {want[0]}, K2-bf16 {want[1]}, fp32 0"] = (
                counts == {"fused_residual_stack": 0, "fused_residual_stack_bf16": want[0],
                           "fused_mrf_stage": 0, "fused_mrf_stage_bf16": want[1]})
            stats[f"{label} served"] = dict(request_s=secs,
                                            audio_s=len(wav) / svs.hp["audio_sample_rate"])
            lines.append(f"{label} served (warm request): {len(wav)} samples, |wav| max "
                         f"{float(np.abs(wav).max()):.3f}, {secs:.3f} s, launches {counts}")

        # ---- (a) speech: CRF head, speaker vectors, LEFT relu FFNs, energy 10**mel ----
        speech = f"{data['speech']},{SPEECH_VARIANT}"
        tr_a = train("v_lj_fs2", cfg["lj_fs2"], speech)
        fs2_a = os.path.join(root, "checkpoints", "v_lj_fs2")
        train("v_lj_ds", cfg["lj_ds_beta6"], f"{speech},fs2_ckpt={fs2_a}")
        svs = SVSInferTorch.from_work_dir(os.path.join(root, "checkpoints", "v_lj_ds"),
                                          os.path.join(tmp, "tts", "assets"), device=dev)
        k, speedup = svs.hp["K_step"], int(svs.hp["pndm_speedup"])
        request = dict(TTS_REQUEST, spk_embed=speech_item["spk_embed"].tolist())
        serve("(a) v_lj_ds, a corpus speaker's vector", svs,
              request, (2 + len(np.arange(0, k, speedup)) - 1, 4))
        with torch.no_grad():  # the vector reaches the conditioner
            b = svs.items_to_batch(svs.score_items([request, dict(request, spk_embed=None)]))
            ret = svs.model.fs2(torch.as_tensor(b["txt_tokens"], device=dev),
                                spk_embed=torch.as_tensor(b["spk_embed"], device=dev),
                                max_frames=b["n_frames"], skip_decoder=True)
        checks["(a) the speaker vector moves the conditioner"] = bool(
            (ret["decoder_inp"][0] - ret["decoder_inp"][1]).abs().max() > 0)
        del svs

        # ---- (b) singing: mixture head, split ids, rel_pos, swish; a LEFT/standard PE ----
        sing = f"{data['sing']},{SING_VARIANT}"
        train("v_fs2", cfg["fs2"], sing)
        fs2_b = os.path.join(root, "checkpoints", "v_fs2")
        train("v_diff", cfg["diff"], f"{sing},fs2_ckpt={fs2_b}")
        f0_mean, f0_std = (float(x) for x in np.load(os.path.join(root, "sing_bin",
                                                                  "train_f0s_mean_std.npy")))
        pe_keys = (f"{data['sing']},task_cls=tasks.tts.pe.PitchExtractionTask,pitch_type=frame,"
                   f"pitch_loss=l1,use_uv=true,ffn_padding=LEFT,pitch_norm=standard,"
                   f"f0_mean={f0_mean},f0_std={f0_std}")
        tr_pe = run.trainer_from_args(run.parse_args(
            ["--config", cfg["diff"], "--exp_name", "v_pe", "--hparams",
             f"{pe_keys},max_updates={VARIANT_STEPS},log_interval=1,val_check_interval=1000,"
             "num_ckpt_keep=2"]))
        pe_grads = {}

        def pe_step(step, metrics):
            if step == 1:
                pe_grads["ok"] = all(p.grad is not None and bool((p.grad != 0).any())
                                     and bool(torch.isfinite(p.grad).all())
                                     for p in tr_pe.task.model.parameters())

        torch.cuda.reset_peak_memory_stats()
        reset()
        with open(log_fn, "a") as logf, contextlib.redirect_stdout(logf):
            tr_pe.fit(on_step=pe_step)
        counts = read("17 train v_pe")
        log = tr_pe.train_log
        t1, tn = log[0][1], log[-1][1]
        st = stats["v_pe"] = dict(first_s=t1 - tr_pe.loop_started,
                                  steps_per_s=(len(log) - 1) / (tn - t1),
                                  mem=torch.cuda.max_memory_allocated() / 2 ** 30,
                                  loss1=log[0][2]["total_loss"], loss_last=log[-1][2]["total_loss"])
        checks["v_pe losses finite"] = all(np.isfinite(v) for _, _, m in log for v in m.values())
        checks["v_pe every parameter's gradient non-zero and finite"] = pe_grads.get("ok", False)
        checks["v_pe no kernel launched in training"] = not any(counts.values())
        lines.append(f"v_pe (PitchExtractor, LEFT convs, pitch_norm standard: f0_mean "
                     f"{f0_mean:.2f}, f0_std {f0_std:.2f} Hz; B={tr_pe.task.hp['max_sentences']}, "
                     f"bf16): first step {st['first_s']:.2f} s, then {st['steps_per_s']:.2f} "
                     f"steps/s; peak memory {st['mem']:.2f} GiB; loss step 1 {st['loss1']:.4f}, "
                     f"step {VARIANT_STEPS} {st['loss_last']:.4f}; launches {counts}")
        # v_pe as v_diff's pe_ckpt: its newest checkpoint, loaded into a PE built
        # from v_diff's config (SAME convs, log f0), as JAX's from_work_dir builds it
        svs = SVSInferTorch.from_work_dir(
            os.path.join(root, "checkpoints", "v_diff"), FLAGSHIP_DIR, device=dev,
            hp_overrides=f"pe_ckpt={os.path.join(root, 'checkpoints', 'v_pe')}")
        checks["(b) f0 from v_pe's newest checkpoint (pe_ckpt)"] = (
            svs.pe is not None and svs.pe.pitch_predictor.conv_0.left == 0)
        serve("(b) v_diff", svs, VARIANT_SCORE, (201, 4))
        with torch.no_grad():  # the LEFT / standard PE in its own config, on a served mel
            mel = svs.synthesize(svs.items_to_batch(svs.score_items([VARIANT_SCORE])),
                                 generator=torch.Generator(device=dev).manual_seed(0))["mel"]
            f0 = tr_pe.task.infer_step(mel)["f0_denorm_pred"]
        checks["(b) the LEFT/standard PE's f0 on the served mel finite"] = bool(
            torch.isfinite(f0).all())
        del svs

        # ---- (c) the FFT denoiser ----
        train("v_fft", cfg["diff"], "diff_decoder_type=fft")
        svs = SVSInferTorch.from_work_dir(os.path.join(root, "checkpoints", "v_fft"),
                                          FLAGSHIP_DIR, device=dev)
        serve("(c) v_fft", svs, VARIANT_SCORE, (0, 4))
        del svs

        # ---- fp32 card vs CPU: one step of each variant task ----
        fp32 = dict(compute_dtype="float32", dropout=0.0, predictor_dropout=0.0)

        def latest(name):
            c = CheckpointManager(os.path.join(root, "checkpoints", name, "ckpt"))
            return load_npz(os.path.join(c.directory, str(c.latest_step()), "params.npz"))

        hp_a = apply_overrides(load_hparams(cfg["lj_fs2"], speech), fp32)
        b_a = next(iter(DataLoader(M4SingerDataset(hp_a, "valid"), hp_a, shuffle=False,
                                   max_sentences=4)))
        b_a = {k: (v[:4, :256] if k in ("mels", "mel2ph", "f0", "uv", "cwt_spec", "energy")
                   else v[:4]) if isinstance(v, np.ndarray) and v.ndim else v
               for k, v in b_a.items()}
        hp_b = apply_overrides(load_hparams_json(cfg["fs2"], sing), fp32)
        hp_c = apply_overrides(load_hparams_json(cfg["diff"], "diff_decoder_type=fft"), fp32)
        vocab_b = int(latest("v_fs2")["token_embed/embed/embedding"].shape[0])
        vocab_c = int(latest("v_fft")["fs2/token_embed/embed/embedding"].shape[0])
        b_b = make_batch(4, 16, 64, vocab_b, seed=17)
        r = np.random.RandomState(17)
        b_b.update(mels=(r.randn(4, 64, 80) * 0.5 - 3).astype(np.float32),
                   word_boundary=r.randint(0, 2, (4, 16)))
        b_b["mels"][b_b["mel2ph"] == 0] = 0.0
        g = torch.Generator().manual_seed(17)
        pins = dict(t=torch.randint(0, hp_c["K_step"], (4,), generator=g),
                    noise=torch.randn((4, 64, 80), generator=g))
        hp_pe = apply_overrides(tr_pe.task.hp, dict(compute_dtype="float32"))
        _, valid_dl = tr_pe.build_dataloaders()
        b_pe = {k: v[:4, :128].cpu().numpy() for k, v in batch_to_device(
            next(iter(valid_dl)), "cpu").items() if k in ("mels", "mel2ph", "f0", "uv")}
        vocab_a = tr_a.task.vocab_size
        reset()
        for label, make, params, batch, pin in (
                ("(a) CRF + speaker vectors", lambda d: AuxDecoderMIDITask(hp_a, vocab_a, device=d),
                 latest("v_lj_fs2"), b_a, {}),
                ("(b) mixture + split ids + rel_pos", lambda d: AuxDecoderMIDITask(
                    hp_b, vocab_b, device=d), latest("v_fs2"), b_b, {}),
                ("(b) PE LEFT/standard", lambda d: PitchExtractionTask(hp_pe, device=d),
                 latest("v_pe"), b_pe, {}),
                ("(c) FFT denoiser", lambda d: DiffSingerMIDITask(hp_c, vocab_c, device=d),
                 latest("v_fft"), b_b, pins)):
            ok, text = step_parity(make, params, batch, pin, dev)
            checks[f"{label} fp32 card vs CPU"] = ok
            lines.append(f"{label} fp32 step card vs CPU ({batch['mels'].shape[0]} x "
                         f"{batch['mels'].shape[1]} frames, every loss): {text}")
        checks["no kernel launched in the parity steps"] = not any(read("17 parity").values())
        lines.append(f"steps/s (first step apart), peak GiB, losses, served request s on {card}: "
                     + json.dumps({k: {kk: round(vv, 4) for kk, vv in v.items()}
                                   for k, v in stats.items()}))
        lines.append(f"phase 17 {time.perf_counter() - t_phase:.1f} s, and its binarizations "
                     f"{res['ended'] - res['started']:.1f} s in the background")
    finally:
        os.chdir(cwd)
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


# ---- phase 18: serving work dirs, and the tools ----------------------------------
# each tool (bisinger_tpu_torch/tools/<name>) at small step counts and full width, with
# its knobs; <tmp> is the smoke's temporary dir. (K1-bf16, K2-bf16) launches: "+" at
# least one, 0 none (a train step launches neither). A functional check: bench_train's
# and bench_serving's figures are read at their own knobs, in a run of their own
# (README.md), not from these windows of 2 steps and 8 requests
TOOLS = (
    ("train_flagship", dict(FL_ITEMS="16", FL_OUT="<tmp>/fl_run", FL_EXPORT="<tmp>/fl_export",
                            FL_FS2_STEPS="2", FL_PE_STEPS="2", FL_DIFF_STEPS="2",
                            FL_VOC_STEPS="2", FL_BATCH="8"), ("+", "+")),
    ("flagship_artifacts", dict(FA_CKPT="<tmp>/fl_export", FA_DATA="<tmp>/fl_run", FA_N="2"),
     ("+", "+")),
    ("sampler_quality", dict(SQ_CKPT="<flagship>", SQ_DATA="<tmp>", SQ_B="8"), (1241, 0)),
    # room for phase 19's launches beside this phase: bench_train without its MFU step
    # (tests/test_torch_tools.py holds the MFU arithmetic), profile_split at B=8 (the
    # tool's default 32) and bench_serving at 4 requests; functional checks whose
    # figures come from runs at their own knobs (PERF.md §5, §6)
    ("bench_train", dict(BT_STEPS="2", BT_VOC="1", BT_VOC_B="4"), (0, 0)),
    ("profile_split", dict(PS_B="8"), ("+", "+")),
    ("bench_serving", dict(SB_N="4", SB_CONC="4", SB_COMPARE="0"), ("+", "+")),
    ("train_convergence", dict(TC_STEPS="4", TC_ITEMS="16", TC_OUT="<tmp>/tc", TC_SMOKE="1"),
     ("+", "+")),
    ("bench_pipeline", dict(BP_STEPS="8", BP_ITEMS="16", BP_OUT="<tmp>/bp"), (0, 0)),
)


def run_tool(name, knobs, log_fn):
    """`bisinger_tpu_torch.tools.<name>.main()` in this process (its kernels'
    launches counted here) with `knobs` in the environment, its output
    appended to `log_fn`: (rc, its JSON lines, seconds, error text or None)."""
    from bisinger_tpu_torch.tools.card import run_main

    with open(log_fn, "a") as logf:
        rc, lines, text, error, secs = run_main(name, knobs, stderr=logf)
        logf.write(f"==== {name} rc {rc} ({secs:.1f} s)\n{text}{error or ''}\n")
    return rc, lines, secs, error and error[-1500:]


def work_dirs_phase(counters, by_path, dev, tmp, card):
    """Phase 18: training runs' work dirs served as JAX serves them, and the
    JAX scripts' counterparts (bisinger_tpu_torch/tools/) on the card, in bf16.
    (a) Phase 10's FFT-Singer work dir (AuxDecoderMIDITask: the conditioner's
    decoder mel, no diffusion) through `run --infer --exp_name fs2`, then the
    same score through the server's `main --exp_name fs2` (in a thread, one
    HTTP request; its 16-bit PCM equal to (a)'s waveform within 2 steps):
    no K1 launch, 4 K2-bf16 each. (b) Phase 12's popcs_fs2 (the flagship
    vocoder) and phase 13's lj/fs2 (its plain HiFi-GAN) work dirs through
    from_work_dir: 0 and 4 each. (c) Phase 10's diffusion work dir with
    pe_ckpt at phase 11's PE run: the PE from its newest checkpoint, its f0
    within 1 Hz of that PE (built from the PE run's own config) applied to
    the served mel directly; 201 and 4. (d) Every tool of TOOLS at small
    step counts and full width, its knobs set, in this process: rc 0
    (train_convergence: its own verdict), its JSON lines with this card's
    name and power limit, its launches; train_flagship's export served by
    from_checkpoint (201, 4). Launch counts go to `launches_by_path["18
    ..."]`; the tools' output to checkpoints/chip_smoke/tools.log. Returns
    (ok, lines)."""
    import contextlib
    import socket
    import threading
    import urllib.request

    import numpy as np

    from bisinger_tpu_torch import run
    from bisinger_tpu_torch.config import load_hparams_json
    from bisinger_tpu_torch.inference import pipeline, server
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch
    from bisinger_tpu_torch.models.pe import PitchExtractor
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.weights import load_flax_params

    repo = os.path.dirname(os.path.abspath(__file__))
    log_fn = os.path.join(repo, "checkpoints", "chip_smoke", "tools.log")
    open(log_fn, "w").close()
    lines, checks, stats = [], {}, {}
    reset, read = launch_counts(counters, by_path)
    t_phase = time.perf_counter()

    def launches(counts):
        return counts["fused_residual_stack_bf16"], counts["fused_mrf_stage_bf16"]

    def only_bf16(counts):
        return counts["fused_residual_stack"] == 0 and counts["fused_mrf_stage"] == 0

    def audible(wav, hop):
        return (len(wav) > 0 and bool(np.isfinite(wav).all())
                and float(np.abs(wav).max()) > 1e-3 and len(wav) % hop == 0)

    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        score = dict(SCORES[0])
        with open("score18.json", "w") as f:
            json.dump([score], f)
        # ---- (a) the FFT-Singer work dir through run --infer and the server ----
        written, save_wav = {}, pipeline.save_wav

        def keep(wav, path, sr, **kw):  # the float waveform behind the 16-bit file
            written[path] = np.array(wav, np.float32)
            return save_wav(wav, path, sr, **kw)

        pipeline.save_wav = keep
        reset()
        t0 = time.perf_counter()
        try:
            with open(log_fn, "a") as logf, contextlib.redirect_stdout(logf):
                rc = run.main(["--infer", "--exp_name", "fs2", "--input", "score18.json",
                               "--out", "out18", "--device", "cuda"])
        finally:
            pipeline.save_wav = save_wav
        secs = time.perf_counter() - t0
        counts = read("18 served fs2, run --infer")
        wav_a = written.get(os.path.join("out18", "pinyin.wav"), np.zeros(0, np.float32))
        checks["(a) FFT-Singer run --infer rc 0"] = rc == 0
        checks["(a) FFT-Singer: no K1, 4 K2-bf16"] = launches(counts) == (0, 4) and \
            only_bf16(counts)
        checks["(a) FFT-Singer: finite, non-silent, whole frames"] = audible(wav_a, 128)
        stats["fs2 run --infer"] = dict(seconds=secs, audio_s=len(wav_a) / 24000)
        lines.append(f"(a) FFT-Singer work dir (checkpoints/fs2, AuxDecoderMIDITask) through run "
                     f"--infer: {len(wav_a)} samples, |wav| max "
                     f"{float(np.abs(wav_a).max(initial=0)):.3f}, {secs:.2f} s with the loading, "
                     f"launches {counts}")

        served = {}
        serve = server.serve

        def keep_httpd(*a, **kw):
            served["httpd"] = serve(*a, **kw)
            return served["httpd"]

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        server.serve = keep_httpd
        reset()
        t0 = time.perf_counter()
        try:
            with open(log_fn, "a") as logf, contextlib.redirect_stdout(logf):
                thread = threading.Thread(target=server.main, daemon=True, args=(
                    ["--exp_name", "fs2", "--port", str(port), "--max-batch", "1"],))
                thread.start()
                while "httpd" not in served and thread.is_alive() \
                        and time.perf_counter() - t0 < 120:
                    time.sleep(0.05)
        finally:
            server.serve = serve
        pcm = np.zeros(0, np.int16)
        if "httpd" in served:
            try:
                req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                             data=json.dumps(score).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    pcm = np.frombuffer(r.read()[44:], "<i2")
            finally:
                served["httpd"].shutdown()
        secs = time.perf_counter() - t0
        counts = read("18 served fs2, server main")
        want = (np.clip(wav_a, -1.0, 1.0) * 32767.0).astype("<i2")
        checks["(a) server main --exp_name: the run --infer waveform within 2 PCM steps"] = (
            pcm.shape == want.shape and len(pcm) > 0
            and int(np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max()) <= 2)
        checks["(a) server: no K1, 4 K2-bf16"] = launches(counts) == (0, 4) and \
            only_bf16(counts)
        stats["fs2 server"] = dict(seconds=secs)
        lines.append(f"(a) the same work dir through server.main --exp_name fs2 (one HTTP "
                     f"request, with the loading): {len(pcm)} samples, {secs:.2f} s, launches "
                     f"{counts}")

        # ---- (b) the plain FastSpeech2 work dirs ----
        for label, work, assets, request in (
                ("popcs_fs2", os.path.join(tmp, "popcs", "checkpoints", "popcs_fs2"),
                 FLAGSHIP_DIR, POPCS_SCORE),
                ("lj_fs2", os.path.join(tmp, "tts", "checkpoints", "lj_fs2"),
                 os.path.join(tmp, "tts", "assets"), TTS_REQUEST)):
            svs = SVSInferTorch.from_work_dir(work, assets, device=dev)
            svs.infer_once(request)  # warm
            reset()
            t0 = time.perf_counter()
            wav = svs.infer_once(request)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read(f"18 served {label}")
            checks[f"(b) {label}: no K1, 4 K2-bf16"] = launches(counts) == (0, 4) and \
                only_bf16(counts)
            checks[f"(b) {label}: finite, non-silent, whole frames"] = audible(
                wav, svs.hp["hop_size"])
            stats[f"{label} served"] = dict(request_s=secs)
            lines.append(f"(b) {label} work dir ({svs.hp['task_cls'].rsplit('.', 1)[-1]}, "
                         f"use_midi {svs.hp['use_midi']}, pitch_type {svs.hp['pitch_type']}, "
                         f"vocoder use_nsf {svs.voc.model.use_nsf}): {len(wav)} samples, "
                         f"|wav| max {float(np.abs(wav).max()):.3f}, warm request {secs:.3f} s, "
                         f"launches {counts}")
            del svs

        # ---- (c) the diffusion work dir with pe_ckpt at phase 11's PE run ----
        pe_dir = os.path.join(tmp, "checkpoints", "pe")
        svs = SVSInferTorch.from_work_dir(os.path.join(tmp, "checkpoints", "diff"), FLAGSHIP_DIR,
                                          device=dev, hp_overrides=f"pe_ckpt={pe_dir}")
        batch = svs.items_to_batch(svs.score_items([score]))
        svs.synthesize(batch, generator=torch.Generator(device=dev).manual_seed(0))  # warm
        reset()
        t0 = time.perf_counter()
        out = svs.synthesize(batch, generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read("18 served diff, pe_ckpt")
        pe = PitchExtractor(load_hparams_json(os.path.join(pe_dir, "config.json")))
        restored = CheckpointManager(os.path.join(pe_dir, "ckpt")).restore()
        load_flax_params(pe, restored["params"])
        with torch.no_grad():
            f0_direct = pe.to(dev).eval()(out["mel"])["f0_denorm_pred"]
        f0_err = float((out["f0"] - f0_direct).abs().max())
        voiced = float((out["f0"] > 0).float().mean())
        checks["(c) the PE restored from pe_ckpt"] = svs.pe is not None
        checks["(c) served f0 within 1 Hz of the PE run applied directly"] = f0_err <= 1.0
        checks["(c) 201 K1-bf16, 4 K2-bf16"] = launches(counts) == (201, 4) and \
            only_bf16(counts)
        stats["diff pe_ckpt served"] = dict(batch_s=secs)
        lines.append(f"(c) checkpoints/diff with pe_ckpt={os.path.relpath(pe_dir, tmp)} (its "
                     f"step {restored['step']}): f0 max |served - the PE run directly| "
                     f"{f0_err:.3e} Hz, voiced share {voiced:.3f}, warm synthesize "
                     f"{secs:.3f} s, launches {counts}")
        del svs, pe

        # ---- (d) the tools ----
        kind = torch.cuda.get_device_name(0)
        for name, knobs, want in TOOLS:
            knobs = {k: v.replace("<tmp>", tmp).replace("<flagship>", FLAGSHIP_DIR)
                     for k, v in knobs.items()}
            reset()
            rc, out_lines, secs, error = run_tool(name, knobs, log_fn)
            counts = read(f"18 tool {name}")
            got = launches(counts)
            ok_rc = rc in ((0, 1) if name == "train_convergence" else (0,)) and error is None
            checks[f"(d) {name} ran (rc {rc})"] = ok_rc
            checks[f"(d) {name} printed JSON with the card's name and power limit"] = bool(
                out_lines) and all(ln.get("card") == kind and ln.get("nvidia_smi") == card
                                   for ln in out_lines)
            checks[f"(d) {name} launches K1-bf16, K2-bf16 {want}"] = only_bf16(counts) and all(
                g > 0 if w == "+" else g == w for g, w in zip(got, want))
            stats[f"tool {name}"] = dict(seconds=secs)
            shown = [{k: v for k, v in ln.items() if k not in ("card", "nvidia_smi", "utts")}
                     for ln in out_lines]
            lines.append(f"(d) {name} {json.dumps(knobs)}: rc {rc}, {secs:.1f} s, launches "
                         f"{counts}; " + (error.splitlines()[-1] if error else json.dumps(shown)))
        svs = SVSInferTorch.from_checkpoint(os.path.join(tmp, "fl_export"), device=dev)
        svs.infer_once(score)  # warm
        reset()
        wav = svs.infer_once(score)
        counts = read("18 train_flagship export served")
        checks["(d) train_flagship's export served by from_checkpoint: 201, 4"] = (
            launches(counts) == (201, 4) and only_bf16(counts) and audible(wav, 128))
        lines.append(f"(d) train_flagship's export through from_checkpoint: {len(wav)} samples, "
                     f"launches {counts}")
        del svs
        lines.append(f"seconds on {card}: " + json.dumps(
            {k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in stats.items()}))
        lines.append(f"phase 18 {time.perf_counter() - t_phase:.1f} s")
    finally:
        os.chdir(cwd)
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


# ---- phase 21: the kernels at the JAX scripts' widths, and remat ----------------
# the widths phase 2 builds before phases 3-20, those they launch (the
# flagship's, and phase 18's train_convergence at C = 64); the others build in
# the background
FIRST_WIDTHS = {"diffnet_stack": [256], "diffnet_stack_bf16": [64, 256],
                "mrf_stage": [32, 64, 128, 256], "mrf_stage_bf16": [32, 64, 128, 256]}
# (c)'s random DiffNets (K1's C) and NSF generators (upsample_initial_channel:
# K2's F = 64-8 and 512-64), at B x T frames (B=4, T=1024: 32 tiles of 128
# frames, K1-bf16's wide path at every one of these C)
WIDTH_K1_C, WIDTH_VOC_CH, WIDTH_B, WIDTH_T = (64, 128, 384, 512), (128, 1024), 4, 1024
# (d): FFT-Singer steps at the flagship's widths with remat on and off
REMAT_STEPS, REMAT_B, REMAT_TOKENS, REMAT_FRAMES = 3, 16, 64, 512


def widths_phase(counters, by_path, dev, tmp, card):
    """Phase 21: the JAX scripts' default runs on the card, at their widths,
    each route (bf16, fp32). (a) tools/train_convergence at its default
    TC_HIDDEN 64 (a 10 x 64 DiffNet: K1 at C = 64), vocoding through a
    128-channel NSF generator (K2 at F = 64, 32, 16, 8) that tools/train_vocoder
    trained 2 steps (TV_CHANNELS 128), handed in through TC_VOC: rc 0 or 1
    (TC_SMOKE's bar at 4 steps), K1 and K2 launched on the route's kernels
    only. (b) tools/sampler_quality's toy mode (a 10 x 64 DiffNet, DDPM-1000 +
    PLMS-200 + DPM-Solver++ 40): 1241 K1 launches. (c) one PLMS call (201
    K1 calls) on a random DiffNet at each C of WIDTH_K1_C, and one vocoder
    pass (4 K2 calls) on a random NSF generator at each
    upsample_initial_channel of WIDTH_VOC_CH: finite outputs. (d) REMAT_STEPS
    FFT-Singer train steps at the flagship's widths (bf16) with remat off and
    on, the same initial parameters and generator: the losses agree within
    1e-5 relative; both peak memories printed. Phase 9 holds every shape
    launched here against the plain versions."""
    from bisinger_tpu_torch.config import load_hparams_json
    from bisinger_tpu_torch.data.dataset import batch_to_device
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, make_batch
    from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
    from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
    from bisinger_tpu_torch.training.tasks import AuxDecoderMIDITask
    from bisinger_tpu_torch.training.vocoder_task import flax_init_ as voc_init_

    repo = os.path.dirname(os.path.abspath(__file__))
    log_fn = os.path.join(repo, "checkpoints", "chip_smoke", "widths.log")
    open(log_fn, "w").close()
    lines, checks, stats = [], {}, {}
    reset, read = launch_counts(counters, by_path)
    t_phase = time.perf_counter()
    routes = {"bf16": ("fused_residual_stack_bf16", "fused_mrf_stage_bf16"),
              "fp32": ("fused_residual_stack", "fused_mrf_stage")}

    def on_route(counts, route, k1, k2):
        """The route's K1 and K2 counts are k1 and k2 ("+": at least one), the
        other route's 0."""
        mine = routes[route]
        other = routes["fp32" if route == "bf16" else "bf16"]
        got = (counts[mine[0]], counts[mine[1]])
        return all(counts[k] == 0 for k in other) and all(
            g > 0 if w == "+" else g == w for g, w in zip(got, (k1, k2)))

    # ---- (a) train_convergence at TC_HIDDEN 64, a 128-channel vocoder ----
    voc_out = os.path.join(tmp, "tc_voc")
    rc, out_lines, secs, error = run_tool("train_vocoder", dict(
        TV_STEPS="2", TV_BATCH="2", TV_FRAMES="16", TV_CHANNELS="128", TV_OUT=voc_out),
        log_fn)
    voc_files = sorted(os.listdir(os.path.join(voc_out, "vocoder"))) if os.path.isdir(
        os.path.join(voc_out, "vocoder")) else []
    checks["(a) train_vocoder wrote a 128-channel generator"] = error is None and any(
        f.startswith("generator_") for f in voc_files)
    lines.append(f"(a) train_vocoder TV_CHANNELS 128, 2 steps: rc {rc}, {secs:.1f} s, "
                 f"{voc_files}")
    for route in ("bf16", "fp32"):
        knobs = dict(TC_STEPS="4", TC_ITEMS="16", TC_OUT=os.path.join(tmp, f"tc21_{route}"),
                     TC_SMOKE="1", TC_VOC=os.path.join(voc_out, "vocoder"),
                     TC_VOC_CHANNELS="128",
                     TC_DTYPE="bfloat16" if route == "bf16" else "float32")
        reset()
        rc, out_lines, secs, error = run_tool("train_convergence", knobs, log_fn)
        counts = read(f"21 (a) train_convergence, {route}")
        summary = out_lines[-1] if out_lines else {}
        checks[f"(a) train_convergence {route} ran (rc {rc})"] = rc in (0, 1) and error is None
        checks[f"(a) train_convergence {route}: the 64-wide DiffNet and the trained "
               "128-channel vocoder"] = summary.get("hidden") == 64 and bool(
            summary.get("wav_vocoder_trained"))
        checks[f"(a) train_convergence {route} launches K1, 4 K2 on its route"] = on_route(
            counts, route, "+", 4)
        stats[f"(a) {route}"] = dict(seconds=secs)
        lines.append(f"(a) train_convergence {route} (TC_HIDDEN 64, TC_VOC 128 channels): rc "
                     f"{rc}, {secs:.1f} s, launches {counts}; "
                     + (error.splitlines()[-1] if error else json.dumps(
                         {k: summary.get(k) for k in ("hidden", "converged",
                                                      "wav_vocoder_trained")})))

    # ---- (b) sampler_quality's toy mode ----
    for route in ("bf16", "fp32"):
        reset()
        rc, out_lines, secs, error = run_tool("sampler_quality", dict(
            SQ_STEPS="4", SQ_DTYPE="bfloat16" if route == "bf16" else "float32"), log_fn)
        counts = read(f"21 (b) sampler_quality toy, {route}")
        checks[f"(b) sampler_quality toy {route} ran"] = rc == 0 and error is None
        checks[f"(b) sampler_quality toy {route}: 1241 K1, no K2"] = on_route(
            counts, route, 1241, 0)
        stats[f"(b) {route}"] = dict(seconds=secs)
        shown = [{k: v for k, v in ln.items() if k in ("plms", "dpmpp")} for ln in out_lines]
        lines.append(f"(b) sampler_quality toy {route}: rc {rc}, {secs:.1f} s, launches "
                     f"{counts}; " + (error.splitlines()[-1] if error else json.dumps(shown)))

    # ---- (c) PLMS on random DiffNets, vocoder passes on random generators ----
    hp_diff = load_hparams_json(os.path.join(FLAGSHIP_DIR, "hparams_diff.json"))
    gen = torch.Generator(device=dev)
    for route in ("bf16", "fp32"):
        dt = "bfloat16" if route == "bf16" else "float32"
        for C in WIDTH_K1_C:
            hp = dict(hp_diff, residual_channels=C, compute_dtype=dt)
            torch.manual_seed(C)
            model = GaussianDiffusion(hp, 64).to(dev).eval()
            net = model.denoise_fn
            for n, p in net.named_parameters():  # flax's zero output projection, drawn
                if n.startswith("output_projection"):
                    p.data.normal_(0.0, 0.05, generator=gen.manual_seed(C))
            gen.manual_seed(C)
            cond = torch.randn((WIDTH_B, WIDTH_T, hp["hidden_size"]), generator=gen, device=dev)
            x = torch.randn((WIDTH_B, WIDTH_T, 80), generator=gen, device=dev)
            reset()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = model.plms_sample_loop(x, net.cond_projections(cond), hp["K_step"],
                                             hp["pndm_speedup"], stack=net.stack_weights())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read(f"21 (c) PLMS C={C}, {route}")
            calls = hp["K_step"] // hp["pndm_speedup"] + 1
            checks[f"(c) PLMS at C={C} {route}: {calls} K1 calls, finite"] = on_route(
                counts, route, calls, 0) and bool(torch.isfinite(out).all())
            lines.append(f"(c) PLMS, a random {hp['residual_layers']} x {C} DiffNet, "
                         f"{route}, B={WIDTH_B} T={WIDTH_T}: {secs:.2f} s, launches {counts}")
            del model, net, out
        for ch in WIDTH_VOC_CH:
            hp = dict(hp_diff, upsample_initial_channel=ch, compute_dtype=dt)
            g = voc_init_(HifiGanGenerator(hp), ch).to(dev).eval()
            gen.manual_seed(ch)
            mel = torch.randn((2, 256, 80), generator=gen, device=dev)
            f0 = 200.0 + 100.0 * torch.rand((2, 256), generator=gen, device=dev)
            reset()
            t0 = time.perf_counter()
            with torch.no_grad():
                wav = g(mel, f0, generator=gen)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read(f"21 (c) vocoder {ch} channels, {route}")
            widths = [ch // 2 ** (i + 1) for i in range(len(hp["upsample_rates"]))]
            checks[f"(c) vocoder {ch} channels {route} (F = {widths}): 4 K2 calls, finite"] = \
                on_route(counts, route, 0, len(widths)) and bool(torch.isfinite(wav).all())
            lines.append(f"(c) vocoder pass, a random NSF generator of {ch} channels (F = "
                         f"{widths}), {route}: {tuple(wav.shape)}, {secs:.2f} s, launches "
                         f"{counts}")
            del g, wav

    # ---- (d) FFT-Singer steps with remat off and on ----
    hp_fs2 = load_hparams_json(os.path.join(FLAGSHIP_DIR, "hparams_fs2.json"))
    batch = make_batch(REMAT_B, REMAT_TOKENS, REMAT_FRAMES, 64, seed=21, targets=True)
    batch["mels"][batch["mel2ph"] == 0] = 0.0
    batch = batch_to_device(batch, dev)
    start, result = None, {}
    for remat in (False, True):
        task = AuxDecoderMIDITask(dict(hp_fs2, remat=remat), 64, device=dev)
        if start is None:
            start = task.state()["params"]
        else:
            task.load_state(start)
        step_gen = torch.Generator(device=dev).manual_seed(21)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        t0 = time.perf_counter()
        losses = [float(task.train_step(batch, step_gen)["total_loss"])
                  for _ in range(REMAT_STEPS)]
        torch.cuda.synchronize()
        counts = read(f"21 (d) FFT-Singer remat {'on' if remat else 'off'}")
        result[remat] = dict(losses=losses, peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                             seconds=time.perf_counter() - t0, counts=counts)
        del task
    off, on = result[False], result[True]
    agree = all(abs(a - b) <= 1e-5 * abs(a) for a, b in zip(off["losses"], on["losses"]))
    checks[f"(d) {REMAT_STEPS} FFT-Singer steps: remat on and off agree within 1e-5"] = agree
    checks["(d) no kernel launched in the train steps"] = not any(
        any(r["counts"].values()) for r in result.values())
    lines.append(f"(d) FFT-Singer at the flagship's widths (hidden {hp_fs2['hidden_size']}, "
                 f"{hp_fs2['enc_layers']} + {hp_fs2['dec_layers']} FFT layers, "
                 f"{hp_fs2['compute_dtype']}), B={REMAT_B}, {REMAT_FRAMES} frames, "
                 f"{REMAT_STEPS} steps: total loss remat off {off['losses']}, on {on['losses']}; "
                 f"peak memory off {off['peak_gib']:.3f} GiB, on {on['peak_gib']:.3f} GiB; "
                 f"seconds off {off['seconds']:.2f}, on {on['seconds']:.2f}")
    lines.append(f"seconds on {card}: " + json.dumps(
        {k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in stats.items()}))
    lines.append(f"phase 21 {time.perf_counter() - t_phase:.1f} s")
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


# ---- phase 19: long-form synthesis over seq ranks, and the pipelined DiffNet -----
SP_FRAMES, SP_RANKS = 4096, 2  # about 21.8 s of audio at hop 128, 24 kHz
PP_STAGES, PP_MICRO, PP_B, PP_T = 5, 4, 4, 256  # 4 layers a stage at the flagship
PAR_TIMEOUT_S = 240.0  # phases 19's and 20's launches, waited for after phase 18
# phase 20: the flagship over TP_RANKS model ranks; (a) and (b) at TP_B x TP_T, (c) one
# synthesize() at B=1, TP_T frames with DPM-Solver++ (40 denoiser calls: 800 all-reduces)
TP_RANKS, TP_B, TP_T, TP_SEED = 2, 4, 256, 20
TP_SAMPLER = dict(diff_sampler="dpmpp", dpm_steps=40)
PAR_RUNS = (("sp", SP_RANKS, "--par-sp"), ("pp", PP_STAGES, "--par-pp"),
            ("tp", TP_RANKS, "--par-tp"))
PAR_SEED = 19


def _kernel_counters():
    from bisinger_tpu_torch.ops import diffnet_stack, mrf_stage

    return {"fused_residual_stack": diffnet_stack.counter,
            "fused_residual_stack_bf16": diffnet_stack.counter_bf16,
            "fused_mrf_stage": mrf_stage.counter,
            "fused_mrf_stage_bf16": mrf_stage.counter_bf16}


def _rank_report(tmp, tag, rank, out, counters):
    """A rank's results and every input shape its counters recorded."""
    out["shapes"] = {k: [list(s[:3]) + ([list(s[3])] if len(s) == 4 else [])
                         for s in c.shapes] for k, c in counters.items()}
    with open(os.path.join(tmp, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def sp_ranks(tmp: str) -> int:
    """Phase 19 (a)'s ranks (torchrun, gloo, sharing the card): the
    long-form batch of sp_batch.npz through `synthesize` under a 'seq' mesh
    of SP_RANKS, in bf16 and in fp32, the draws from a generator seeded
    PAR_SEED; each rank reports its launches and seconds, rank 0 writes the
    gathered mel, f0 and waveform (sp_<route>.npz)."""
    import numpy as np

    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch
    from bisinger_tpu_torch.parallel import mesh as dp
    from bisinger_tpu_torch.parallel import sequence

    full_fp32()
    dev = dp.init_data_parallel("cuda:0", "gloo")
    counters, out = _kernel_counters(), {}
    try:
        batch = dict(np.load(os.path.join(tmp, "sp_batch.npz")))
        with sequence.make_seq_mesh(num_seq=SP_RANKS) as mesh:
            for route, over in (("bf16", {}), ("fp32", {"compute_dtype": "float32"})):
                svs = SVSInferTorch.from_checkpoint(FLAGSHIP_DIR, device=dev, hp_overrides=dict(
                    over, sequence_parallel_axis="seq"))
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                res = svs.synthesize(batch, generator=torch.Generator(device=dev).manual_seed(
                    PAR_SEED))
                torch.cuda.synchronize()
                out[route] = dict(secs=time.perf_counter() - t0,
                                  counts={k: c.launches for k, c in counters.items()},
                                  core=list(res["mel"].shape))
                whole = {k: sequence.gather_frames(res[k].float(), mesh)
                         for k in ("mel", "f0", "wav")}
                if mesh.index == 0:
                    np.savez(os.path.join(tmp, f"sp_{route}.npz"),
                             **{k: v.cpu().numpy() for k, v in whole.items()})
                del svs, res, whole
        _rank_report(tmp, "sp", dp.rank(), out, counters)
    finally:
        dp.shutdown()
    return 0


def pp_ranks(tmp: str) -> int:
    """Phase 19 (b)'s ranks (torchrun, gloo, sharing the card): the flagship
    DiffNet over a 'pipe' mesh of PP_STAGES, each rank its 4 layers from
    diff_params.npz, PP_MICRO micro-batches; one denoiser call and a
    PLMS-200 loop on pp_inputs.npz; each rank reports its launches, seconds
    and a digest of its results, rank 0 writes them (pp_out.npz)."""
    import numpy as np

    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.config import load_hparams_json
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR
    from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
    from bisinger_tpu_torch.parallel import mesh as dp
    from bisinger_tpu_torch.parallel import pipeline

    full_fp32()
    dev = dp.init_data_parallel("cuda:0", "gloo")
    counters, out = _kernel_counters(), {}
    try:
        hp = load_hparams_json(os.path.join(FLAGSHIP_DIR, "hparams_diff.json"))
        params_fn = os.path.join(FLAGSHIP_DIR, "diff_params.npz")
        with np.load(params_fn) as z:
            vocab = int(z["fs2/token_embed/embed/embedding"].shape[0])
        inp = {k: torch.as_tensor(v).to(dev) for k, v in
               np.load(os.path.join(tmp, "pp_inputs.npz")).items()}
        with torch.no_grad(), pipeline.make_pipe_mesh(PP_STAGES) as mesh:
            stage = pipeline.pipelined_denoiser(hp, mesh, PP_MICRO)
            pipeline.load_stage_params(stage, params_fn)
            stage.to(dev)
            stack = stage.stack_weights()
            cond_proj = stage.cond_projections(inp["cond"]).contiguous()
            results = {}
            for part in ("call", "plms"):
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                if part == "call":
                    results[part] = stage(inp["x"], inp["t"], cond_proj, stack)
                else:
                    model = GaussianDiffusion(hp, vocab, 80)
                    model.denoise_fn = stage
                    model.to(dev).eval()
                    results[part] = model.denorm_spec(model.plms_sample_loop(
                        inp["x"], cond_proj, model.K_step, int(hp["pndm_speedup"]), stack))
                torch.cuda.synchronize()
                out[part] = dict(secs=time.perf_counter() - t0,
                                 counts={k: c.launches for k, c in counters.items()},
                                 digest=dp.digest([results[part]]))
            if dp.rank() == 0:
                np.savez(os.path.join(tmp, "pp_out.npz"),
                         **{k: v.float().cpu().numpy() for k, v in results.items()})
        out["layers"] = list(stage.layer_ids)
        _rank_report(tmp, "pp", dp.rank(), out, counters)
    finally:
        dp.shutdown()
    return 0


def tp_rounded_partials(net, x, t, cond_proj, n):
    """The DiffNet's layer path with each of n model ranks' share of every
    output projection rounded to compute_dtype before the shares are summed:
    a TP that rounds its partial sums where this design rounds once after
    the all-reduce. Phase 20 (a)'s bf16 control, in one process."""
    import math

    import torch.nn.functional as F

    from bisinger_tpu_torch.models.common import div, softplus
    from bisinger_tpu_torch.models.diffnet import diffusion_step_embedding

    dt = net.dtype_
    h = torch.relu(net.input_projection(x))
    s = net.mlp_0(diffusion_step_embedding(t, net.channels))
    s = net.mlp_1(s * torch.tanh(softplus(s)))
    total, k = None, net.channels // n
    for blk, cp in zip(net.blocks(), cond_proj):
        y = blk.dilated_conv(h + blk.diffusion_projection(s)[:, None, :]) + cp
        gate, filt = y.chunk(2, dim=-1)
        a = (torch.sigmoid(gate) * torch.tanh(filt)).to(dt)
        w = blk.output_projection.weight.to(dt)
        out = sum(F.linear(a[..., i * k:(i + 1) * k], w[:, i * k:(i + 1) * k]) for i in range(n))
        residual, skip = (out + blk.output_projection.bias.to(dt)).chunk(2, dim=-1)
        h = div(h + residual, math.sqrt(2.0))
        total = skip if total is None else total + skip
    y = div(total, math.sqrt(net.n_layers))
    return net.output_projection(torch.relu(net.skip_projection(y)))


def tp_ranks(tmp: str) -> int:
    """Phase 20's ranks (torchrun, gloo, sharing the card): the flagship
    (SVSInferTorch.from_checkpoint with DPM-Solver++, TP_SAMPLER) under
    make_mesh(num_data=1, num_model=TP_RANKS), in bf16 and fp32, through
    the rank's TP views (`tp_views`): (a) one DiffNet call on tp_inputs.npz
    (TP_B x TP_T), (b) the PE and the NSF HiFi-GAN on its mel and f0, the
    NSF draws pinned, (c) one synthesize() of tp_batch.npz (B=1, TP_T
    frames, mel2ph given), the draws from a generator seeded TP_SEED; each
    part's launches and seconds a rank, and a digest of its results. Then,
    outside the mesh, each rank alone runs a share of the unsharded
    references on the same inputs: rank 0 (a) the DiffNet's layer path and
    the bf16 control (`tp_rounded_partials`), (b) the unsharded PE and the
    generator's layer path (train mode's MRF branch) and, reported, its K2
    path; rank 1 (c) one process's synthesize() (K1 and K2). Rank 0 writes
    the results and its references to tp_<route>_rank0.npz, rank 1 its
    reference to tp_<route>_rank1.npz; the report has each rank's clock
    (seconds since its start) at each step."""
    import numpy as np

    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch
    from bisinger_tpu_torch.parallel import mesh as dp
    from bisinger_tpu_torch.parallel import tensor

    full_fp32()
    dev = dp.init_data_parallel("cuda:0", "gloo")
    counters, out, clock = _kernel_counters(), {}, {}
    stamp = lambda what: clock.__setitem__(what, round(time.perf_counter() - T_START, 2))  # noqa
    stamp("joined")
    try:
        inp = {k: torch.as_tensor(v).to(dev) for k, v in
               np.load(os.path.join(tmp, "tp_inputs.npz")).items()}
        batch = dict(np.load(os.path.join(tmp, "tp_batch.npz")))
        mesh = tensor.make_mesh(num_data=1, num_model=TP_RANKS)
        gen = lambda: torch.Generator(device=dev).manual_seed(TP_SEED)  # noqa: E731
        for route, over in (("bf16", {}), ("fp32", {"compute_dtype": "float32"})):
            svs = SVSInferTorch.from_checkpoint(FLAGSHIP_DIR, device=dev, hp_overrides=dict(
                over, **TP_SAMPLER))
            stamp(f"{route} loaded")
            rep, res = {}, {}
            dp.barrier()  # the other rank's references end before the parts are timed

            def run(part, fn):
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                y = fn()
                torch.cuda.synchronize()
                rep[part] = dict(secs=time.perf_counter() - t0,
                                 counts={k: c.launches for k, c in counters.items()})
                return y

            with torch.no_grad(), mesh:
                model, pe, voc = run("views", lambda: svs.tp_views(mesh))
                net = model.denoise_fn
                res["diffnet"] = run("a", lambda: net(inp["x"], inp["t"],
                                                      net.cond_projections(inp["cond"])))
                res["f0"] = run("b pe", lambda: pe(inp["mel"])["f0_denorm_pred"])
                res["wav"] = run("b vocoder", lambda: voc.generate(
                    inp["mel"], inp["f0"], phase=inp["phase"], noise=inp["noise"]))
                syn = run("c", lambda: svs.synthesize(batch, generator=gen()))
                res.update({f"syn_{k}": v for k, v in syn.items()})
            for part in ("a", "b pe", "b vocoder", "c"):
                keys = {"a": ["diffnet"], "b pe": ["f0"], "b vocoder": ["wav"],
                        "c": [f"syn_{k}" for k in ("mel", "f0", "wav")]}[part]
                rep[part]["digest"] = dp.digest([res[k] for k in keys])
            out[route] = rep
            stamp(f"{route} parts")
            ref = {}  # the unsharded references, each rank alone its share
            with torch.no_grad(), dp.using_data_group(mesh.data_group):
                if mesh.index == 0:
                    net = svs.model.denoise_fn
                    cp = net.cond_projections(inp["cond"])
                    ref["diffnet"] = net._forward_layers(inp["x"], inp["t"], cp)
                    ref["diffnet_control"] = tp_rounded_partials(net, inp["x"], inp["t"], cp,
                                                                 TP_RANKS)
                    ref["f0"] = svs.pe(inp["mel"])["f0_denorm_pred"]
                    pins = dict(phase=inp["phase"], noise=inp["noise"])
                    svs.vocoder.train()  # the MRF's layer branch
                    ref["wav"] = svs.voc.generate(inp["mel"], inp["f0"], **pins)
                    svs.vocoder.eval()
                    ref["wav_k2"] = svs.voc.generate(inp["mel"], inp["f0"], **pins)
                else:
                    syn = svs.synthesize(batch, generator=gen())
                    ref.update({f"syn_{k}": v for k, v in syn.items()})
            np.savez(os.path.join(tmp, f"tp_{route}_rank{mesh.index}.npz"),
                     **({k: v.float().cpu().numpy() for k, v in res.items()}
                        if mesh.index == 0 else {}),
                     **{f"ref_{k}": v.float().cpu().numpy() for k, v in ref.items()})
            stamp(f"{route} references")
            del svs, model, pe, voc, net, res
        out["clock"] = clock
        _rank_report(tmp, "tp", dp.rank(), out, counters)
    finally:
        dp.shutdown()
    return 0


def par_start(svs, dev, tmp):
    """Phases 19 and 20: writes the inputs and starts the three launches
    (torchrun over gloo, the ranks sharing the card), which run beside phase
    18; `par_wait` waits for them, `par_phase` and `tp_phase` check. 19 (a)
    a long-form batch of SP_FRAMES frames at B=1 (make_batch, mel2ph given:
    the conditioner, PLMS-200, the PE and the NSF HiFi-GAN) over SP_RANKS
    seq ranks; 19 (b) the flagship DiffNet over PP_STAGES pipe ranks at
    B=PP_B, T=PP_T, PP_MICRO micro-batches; 20 the flagship over TP_RANKS
    model ranks (`tp_ranks`)."""
    import numpy as np

    from bisinger_tpu_torch.inference.pipeline import make_batch

    repo = os.path.dirname(os.path.abspath(__file__))
    np.savez(os.path.join(tmp, "sp_batch.npz"),
             **make_batch(1, 128, SP_FRAMES, svs.vocab_size, seed=PAR_SEED))
    g = torch.Generator().manual_seed(PAR_SEED)
    np.savez(os.path.join(tmp, "pp_inputs.npz"),
             x=torch.randn((PP_B, PP_T, 80), generator=g).numpy(),
             t=torch.randint(0, svs.hp["K_step"], (PP_B,), generator=g).numpy(),
             cond=torch.randn((PP_B, PP_T, svs.hp["hidden_size"]), generator=g).numpy())
    g = torch.Generator().manual_seed(TP_SEED)
    hop = svs.hp["hop_size"]
    np.savez(os.path.join(tmp, "tp_inputs.npz"),
             x=torch.randn((TP_B, TP_T, 80), generator=g).numpy(),
             t=torch.randint(0, svs.hp["K_step"], (TP_B,), generator=g).numpy(),
             cond=torch.randn((TP_B, TP_T, svs.hp["hidden_size"]), generator=g).numpy(),
             # a log-mel's range, and a voiced f0 at 150-350 Hz
             mel=(1.5 * torch.randn((TP_B, TP_T, 80), generator=g) - 5.0).numpy(),
             f0=(150.0 + 200.0 * torch.rand((TP_B, TP_T), generator=g)).numpy(),
             phase=torch.rand((TP_B, 9), generator=g).numpy(),
             noise=torch.randn((TP_B, TP_T * hop, 9), generator=g).numpy())
    np.savez(os.path.join(tmp, "tp_batch.npz"),
             **make_batch(1, 32, TP_T, svs.vocab_size, seed=TP_SEED))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    launches = DPLaunches()
    for tag, n, flag in PAR_RUNS:
        with open(os.path.join(tmp, f"{tag}.out"), "w") as out:
            launches.start(tag, subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", str(n), os.path.join(repo, "chip_smoke.py"), flag, tmp],
                env=env, stdout=out, stderr=subprocess.STDOUT))
    return launches


def par_only() -> int:
    """`chip_smoke.py --par-only`: phases 19 and 20 alone (the kernels built
    first), for work on them; prints their lines and the launches and shapes
    they read."""
    import shutil
    import tempfile

    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch
    from bisinger_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    full_fp32()
    _build.build_all(log=log)
    dev = torch.device("cuda")
    svs32 = SVSInferTorch.from_checkpoint(FLAGSHIP_DIR, device=dev,
                                          hp_overrides=dict(compute_dtype="float32"))
    svs = SVSInferTorch.from_checkpoint(FLAGSHIP_DIR, device=dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_par_")
    counters, by_path = _kernel_counters(), {}
    par = par_start(svs, dev, tmp)
    try:
        ranks, failed, waited = par_wait(par, counters, tmp)
        with Phase("19 sequence and pipeline parallel") as ph:
            ok, lines = par_phase(par, ranks, failed, waited, svs, svs32, by_path, dev, tmp)
            ph.done(" | ".join(lines))
        with Phase("20 tensor parallel") as ph:
            ok_tp, lines = tp_phase(ranks, failed, by_path, tmp)
            ph.done(" | ".join(lines))
        ok = ok and ok_tp
    finally:
        par.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    log(json.dumps({"launches_by_path": by_path,
                    "shapes": {k: sorted(map(str, c.shapes)) for k, c in counters.items()}}))
    return 0 if ok else 1


def _k1_tiles(B, T, bf16):
    """The K1 tiling the kernels pick at this shape (132 SMs on an H100 SXM)."""
    rows = 128 if bf16 else 64
    return rows if B * -(-T // rows) >= 132 else 16


def par_wait(launches, counters, tmp):
    """Waits for `par_start`'s launches (ending what runs past
    PAR_TIMEOUT_S): ({tag: [each rank's report]} of the launches that ended
    well, {tag: failure text} of the others, seconds waited here). Each
    report's counter shapes go into the parent's counters (phase 9 checks
    them)."""
    t0 = time.perf_counter()
    launches.wait(PAR_TIMEOUT_S)
    waited, secs, ranks, failed = time.perf_counter() - t0, launches.secs, {}, {}
    for tag, n, _ in PAR_RUNS:
        if tag not in secs or launches.procs[tag].returncode != 0:
            with open(os.path.join(tmp, f"{tag}.out")) as f:
                failed[tag] = (f"{tag} ranks failed (rc {launches.procs[tag].returncode}"
                               f"{'' if tag in secs else f', past {PAR_TIMEOUT_S:.0f} s'}): "
                               f"{f.read()[-3000:]}")
            continue
        ranks[tag] = []
        for r in range(n):
            with open(os.path.join(tmp, f"{tag}_rank{r}.json")) as f:
                rep = json.load(f)
            for name, shapes in rep.pop("shapes").items():
                counters[name].shapes.update(
                    tuple(s[:3]) + ((tuple(s[3]),) if len(s) == 4 else ()) for s in shapes)
            ranks[tag].append(rep)
    return ranks, failed, waited


def par_phase(launches, ranks, failed, waited, svs, svs32, by_path, dev, tmp):
    """Phase 19's checks, once `par_start`'s launches have ended. (a) against
    one process's unsharded run of the same batch and generator seed: fp32
    mel within JAX's SP bound (rtol/atol 1e-4,
    tests/test_sequence_parallel.py), f0 within 1e-4/1e-3, as is the
    unsharded PE's f0 on the SP run's gathered mel, and the waveform
    of the unsharded vocoder fed the SP run's gathered mel and f0 within
    1e-4/1e-5 (end to end the waveform is reported: the NSF phase
    integrates f0, phase 5); bf16 mel and that waveform within K1's mean
    bound (MEAN_TOLERANCE_BF16, 4e-3 of the mean |value|), their max and
    f0 reported; K1 201 and K2 4 launches a rank on each route. (b) the
    pipelined denoiser call against the unsplit K1 call within K1's bf16
    tolerances, the PLMS-200 loop through it against the unsplit loop
    within phase 5's bf16 contract, the ranks' results bit-identical, 201 x
    PP_MICRO write-last K1-bf16 launches a rank. Each rank's counts go into
    `by_path`, its counters' shapes into the parent's (phase 9 checks
    them). A functional check: ranks sharing one card say nothing of
    scaling over cards. Returns (ok, lines)."""
    import numpy as np

    from bisinger_tpu_torch.inference.pipeline import make_batch
    from bisinger_tpu_torch.ops import diffnet_stack

    if "sp" in failed or "pp" in failed:
        return False, [failed[t] for t in ("sp", "pp") if t in failed]
    secs = launches.secs
    lines, checks = [], {}
    k1, k2, k1b, k2b = ("fused_residual_stack", "fused_mrf_stage", "fused_residual_stack_bf16",
                        "fused_mrf_stage_bf16")
    n_calls = svs.hp["K_step"] // svs.hp["pndm_speedup"] + 1

    # ---- (a) long-form synthesis over SP_RANKS seq ranks ----
    batch = make_batch(1, 128, SP_FRAMES, svs.vocab_size, seed=PAR_SEED)
    for route, model, (kt, vt) in (("fp32", svs32, (k1, k2)), ("bf16", svs, (k1b, k2b))):
        for r, rep in enumerate(ranks["sp"]):
            counts = rep[route]["counts"]
            by_path[f"19 (a) seq rank {r}, {route}"] = counts
            checks[f"(a) {route} rank {r}: K1 {n_calls}, K2 4"] = counts == {
                k: (n_calls if k == kt else 4 if k == vt else 0) for k in counts}
        sp = dict(np.load(os.path.join(tmp, f"sp_{route}.npz")))
        with torch.no_grad():
            one = model.synthesize(batch, generator=torch.Generator(device=dev).manual_seed(
                PAR_SEED))
            # the vocoder's draws as in the run: after the diffusion's start noise
            g = torch.Generator(device=dev).manual_seed(PAR_SEED)
            torch.randn(tuple(sp["mel"].shape), generator=g, device=dev)
            same_in = model.vocoder(torch.as_tensor(sp["mel"], device=dev),
                                    torch.as_tensor(sp["f0"], device=dev), generator=g)
            # the unsharded PE on the SP run's gathered mel: the split PE's own share
            same_mel = model.pe(torch.as_tensor(sp["mel"], device=dev))["f0_denorm_pred"]
        ref = {k: one[k].float().cpu().numpy() for k in ("mel", "f0", "wav")}
        ref["wav, same mel and f0"] = same_in.float().cpu().numpy()
        ref["f0, same mel"] = same_mel.float().cpu().numpy()
        got = dict(sp, **{"wav, same mel and f0": sp["wav"], "f0, same mel": sp["f0"]})
        core = ranks["sp"][0][route]["core"]
        text = []
        for key, (rtol, atol) in (("mel", (1e-4, 1e-4)), ("f0", (1e-4, 1e-3)),
                                  ("f0, same mel", (1e-4, 1e-3)),
                                  ("wav, same mel and f0", (1e-4, 1e-5)), ("wav", (None, None))):
            a, b = got[key].astype(np.float64), ref[key].astype(np.float64)
            if a.shape != b.shape:
                checks[f"(a) {route} {key} shape"] = False
                continue
            d = np.abs(a - b)
            mean_rel = d.mean() / max(np.abs(b).mean(), 1e-30)
            reading = f"{key} max |diff| {d.max():.3e}, mean {mean_rel:.3e} of mean |value|"
            if route == "fp32" and rtol is not None:
                over = float((d - (atol + rtol * np.abs(b))).max())
                checks[f"(a) fp32 {key} within rtol {rtol:g} atol {atol:g}"] = over <= 0
                reading += f", worst over rtol/atol {over:.3e}"
            elif route == "bf16" and key in ("mel", "wav, same mel and f0"):
                checks[f"(a) bf16 {key} mean within {diffnet_stack.MEAN_TOLERANCE_BF16:g}"] = (
                    mean_rel <= diffnet_stack.MEAN_TOLERANCE_BF16)
            else:
                reading += " (reported)"
            text.append(reading)
        tiles = {T: _k1_tiles(1, T, route == "bf16") for T in (SP_FRAMES, core[1] + 75)}
        lines.append(f"(a) {route}, T={SP_FRAMES} over {SP_RANKS} seq ranks (cores {core}, K1 "
                     f"on {core[1] + 75} frames: {tiles[core[1] + 75]}-frame tiles, unsharded "
                     f"{tiles[SP_FRAMES]}): " + "; ".join(text) + "; seconds a rank "
                     + ", ".join(f"{rep[route]['secs']:.2f}" for rep in ranks["sp"]))

    # ---- (b) the pipelined DiffNet over PP_STAGES pipe ranks ----
    pp = dict(np.load(os.path.join(tmp, "pp_out.npz")))
    inp = {k: torch.as_tensor(v).to(dev) for k, v in
           np.load(os.path.join(tmp, "pp_inputs.npz")).items()}
    net = svs.model.denoise_fn
    with torch.no_grad():
        stack = net.stack_weights()
        cp = net.cond_projections(inp["cond"]).contiguous()
        ref_call = net(inp["x"], inp["t"], cp, stack).float().cpu()
        ref_plms = svs.model.denorm_spec(svs.model.plms_sample_loop(
            inp["x"], cp, svs.model.K_step, int(svs.hp["pndm_speedup"]), stack)).float().cpu()
    err, rel, mean = rel_err(torch.as_tensor(pp["call"]), ref_call)
    checks["(b) one call within K1's bf16 tolerances"] = (
        rel <= diffnet_stack.TOLERANCE_BF16 and mean <= diffnet_stack.MEAN_TOLERANCE_BF16)
    diff = (torch.as_tensor(pp["plms"]).double() - ref_plms.double()).abs()
    scale = ref_plms.abs().mean().item()
    mean_r, max_r = diff.mean().item() / scale, diff.max().item() / scale
    checks["(b) PLMS-200 within phase 5's bf16 contract"] = mean_r < 0.02 and max_r < 0.2
    for part in ("call", "plms"):
        digests = {rep[part]["digest"] for rep in ranks["pp"]}
        checks[f"(b) {part}: every rank's result bit-identical"] = len(digests) == 1
    for r, rep in enumerate(ranks["pp"]):
        by_path[f"19 (b) pipe rank {r}, one call"] = rep["call"]["counts"]
        by_path[f"19 (b) pipe rank {r}, PLMS-200"] = rep["plms"]["counts"]
        checks[f"(b) rank {r}: {n_calls} x {PP_MICRO} write-last K1-bf16"] = (
            rep["plms"]["counts"] == {k: n_calls * PP_MICRO if k == k1b else 0
                                      for k in rep["plms"]["counts"]})
    lines.append(
        f"(b) flagship DiffNet over {PP_STAGES} pipe ranks (layers "
        + ", ".join(f"{rep['layers'][0]}-{rep['layers'][-1]}" for rep in ranks["pp"])
        + f"), B={PP_B} T={PP_T}, {PP_MICRO} micro-batches, bf16: one call against the "
        f"unsplit K1 call max_abs {err:.3e}, relative max {rel:.3e} mean {mean:.3e} (tolerance "
        f"{diffnet_stack.TOLERANCE_BF16:g}/{diffnet_stack.MEAN_TOLERANCE_BF16:g}); PLMS-200 "
        f"against the unsplit loop mean |diff| {100 * mean_r:.4f}%, max {100 * max_r:.4f}% of "
        f"mean |value| {scale:.4g} (contract 2% / 20%); seconds a rank, call / PLMS-200: "
        + ", ".join(f"{rep['call']['secs']:.2f}/{rep['plms']['secs']:.2f}"
                    for rep in ranks["pp"]))
    lines.append("launches (torchrun, the three at once and beside phase 18, ranks sharing "
                 "the card over gloo: a functional check, not a scaling figure; seconds from "
                 "the start to each one's end, imports and loading included): "
                 + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
                 + f"; waited for here {waited:.1f} s")
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


# phase 20 (a)'s bf16 bound: the mean |diff| of the sharded DiffNet call from the
# unsharded layer path, of the mean |value|. Set from the CPU rehearsal at B=4, T=256
# (PERF.md §6): the sharded call 3.5e-3 (rounding flips, one in 2e4 values a layer, which
# 20 layers amplify), the control (`tp_rounded_partials`) 6.7e-3, which must read above it
TP_MEAN_BF16 = 5e-3


def tp_phase(ranks, failed, by_path, tmp):
    """Phase 20's checks, once `par_start`'s launches have ended: on each
    route and model rank, no K1 and no K2 launch in any part (by design:
    neither kernel holds a layer's all-reduce), the ranks' results
    bit-identical; (a) the sharded DiffNet call against the unsharded layer
    path, fp32 relative max within 1e-4, bf16 mean within TP_MEAN_BF16 and
    its control above it; (b) the sharded PE's f0 against the unsharded
    PE's and the sharded generator against its layer path, fp32 within JAX's
    TP bounds (tests/test_multichip.py: f0 rtol 2e-4 atol 2e-3, waveform 5e-3
    / 5e-4), bf16 mean within TP_MEAN_BF16, and the generator's K2 path
    beside it (reported); (c) synthesize() with DPM-Solver++ against one
    process's (K1 and K2), finite and of its shape, the gap reported, as
    phase 19 reports its end-to-end gap. Returns (ok, lines)."""
    import numpy as np

    if "tp" in failed:
        return False, [failed["tp"]]
    lines, checks = [], {}
    for route in ("fp32", "bf16"):
        reps = [rep[route] for rep in ranks["tp"]]
        for r, rep in enumerate(reps):
            for part in ("a", "b pe", "b vocoder", "c"):
                by_path[f"20 ({part}) model rank {r}, {route}"] = rep[part]["counts"]
                checks[f"{route} ({part}) rank {r}: no K1, no K2"] = not any(
                    rep[part]["counts"].values())
        for part in ("a", "b pe", "b vocoder", "c"):
            checks[f"{route} ({part}) ranks bit-identical"] = len(
                {rep[part]["digest"] for rep in reps}) == 1
        z = {k: torch.as_tensor(v) for r in range(TP_RANKS) for k, v in np.load(
            os.path.join(tmp, f"tp_{route}_rank{r}.npz")).items()}
        text = []
        err, rel, mean = rel_err(z["diffnet"], z["ref_diffnet"])
        reading = f"(a) DiffNet B={TP_B} T={TP_T}: max_abs {err:.3e}, relative max {rel:.3e} mean "
        reading += f"{mean:.3e}"
        if route == "fp32":
            checks["fp32 (a) relative max within 1e-4"] = rel <= 1e-4
        else:
            _, crel, cmean = rel_err(z["ref_diffnet_control"], z["ref_diffnet"])
            checks[f"bf16 (a) mean within {TP_MEAN_BF16:g}"] = mean <= TP_MEAN_BF16
            checks["bf16 (a) control above the bound"] = cmean > TP_MEAN_BF16
            reading += (f" (bound {TP_MEAN_BF16:g}; control, each rank's partial sums rounded "
                        f"to bf16: {cmean:.3e})")
        text.append(reading)
        for key, name, (rtol, atol) in (("f0", "(b) PE f0", (2e-4, 2e-3)),
                                        ("wav", "(b) vocoder", (5e-3, 5e-4))):
            a, b = z[key].double(), z[f"ref_{key}"].double()
            err, rel, mean = rel_err(a, b)
            over = float((a - b).abs().sub(atol + rtol * b.abs()).max())
            reading = f"{name}: max_abs {err:.3e}, mean {mean:.3e}"
            if route == "fp32":
                checks[f"fp32 {name} within rtol {rtol:g} atol {atol:g}"] = over <= 0
                reading += f", worst over rtol/atol {over:.3e}"
            else:
                checks[f"bf16 {name} mean within {TP_MEAN_BF16:g}"] = mean <= TP_MEAN_BF16
            if key == "wav":
                k2, k2rel, k2mean = rel_err(a, z["ref_wav_k2"].double())
                reading += f"; against the K2 path (reported) max_abs {k2:.3e}, mean {k2mean:.3e}"
            text.append(reading)
        gaps = []
        for key in ("mel", "f0", "wav"):
            a, b = z[f"syn_{key}"], z[f"ref_syn_{key}"]
            ok = a.shape == b.shape and bool(torch.isfinite(a).all())
            checks[f"{route} (c) {key} finite, shaped as one process's"] = ok
            if ok:
                err, rel, mean = rel_err(a, b)
                gaps.append(f"{key} max |diff| {err:.3e}, mean {mean:.3e}")
        text.append(f"(c) synthesize() B=1 T={TP_T} DPM-Solver++ ({TP_SAMPLER['dpm_steps']} "
                    "calls) against one process (K1, K2; reported): " + ", ".join(gaps))
        text.append("seconds a rank, views / (a) / (b) PE / (b) vocoder / (c): " + "; ".join(
            " / ".join(f"{rep[p]['secs']:.2f}" for p in ("views", "a", "b pe", "b vocoder", "c"))
            for rep in reps))
        lines.append(f"{route}, {TP_RANKS} model ranks: " + " | ".join(text))
    lines.append("each rank's clock (s since its start): " + "; ".join(
        ", ".join(f"{k} {v:.1f}" for k, v in rep["clock"].items()) for rep in ranks["tp"]))
    bad = [k for k, v in checks.items() if not v]
    lines.append(("FAILED " + ", ".join(bad)) if bad else "checks " + ", ".join(checks))
    return not bad, lines


# ---- the host's share, in the background ----------------------------------------
# Phases 10, 12, 13, 16 and 17 each start from a corpus binarized on the host
# (16 from the corpus tools' metas, 17 from 10's and 13's corpora). One process
# of its own (`--prepare`, at the lowest CPU priority) writes them all from the
# start of the run, in the order the phases need them, while the card runs
# phases 2-8; each phase waits for its part.
def popcs_data(root):
    """Phase 12's data keys. The synthetic items are named
    "<singer>#song<i % 3>#<i:04d>": the configs' PopCS song names match none;
    4 items are held out."""
    return (f'raw_data_dir={root}/raw,binary_data_dir={root}/binary,'
            f'test_prefixes=["song0#000"]')


def tts_data(root):
    return f"raw_data_dir={root}/raw,raw_json_fn=meta.json,binary_data_dir={root}/binary"


def paper_data(root, metas):
    """Phase 16's data keys for each of its metas."""
    data = {}
    for name, (raw, fn) in metas.items():
        data[name] = f"raw_data_dir={raw},raw_json_fn={fn},binary_data_dir={root}/bin_{name}"
        if name != "les":
            data[name] += ",test_prefixes=" + json.dumps(M4_TEST_PREFIXES).replace(" ", "")
    return data


def _binarize_env(n_proc):
    repo = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, N_PROC=str(n_proc),
                PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))


def binarize_cli(argv, cwd, n_proc):
    """`run <argv> --binarize` in a process of its own with `n_proc`
    workers: its rc, output and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "bisinger_tpu_torch.run", *argv, "--binarize"],
                          cwd=cwd, env=_binarize_env(n_proc), capture_output=True, text=True,
                          timeout=300)
    return dict(rc=proc.returncode, stdout=proc.stdout, stderr=proc.stderr,
                seconds=time.perf_counter() - t0)


def prep_training(tmp):
    """Phase 10's corpus (TRAIN_ITEMS synthetic items, seed 0), its two stages'
    configs (tmp/fs2.json, tmp/diff.json) and its binarization."""
    from bisinger_tpu_torch.config import load_hparams_json
    from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR

    make_synthetic_corpus(os.path.join(tmp, "raw"), n_items=TRAIN_ITEMS, seed=0)
    data = dict(raw_data_dir=os.path.join(tmp, "raw"),
                binary_data_dir=os.path.join(tmp, "binary"), max_updates=TRAIN_STEPS,
                val_check_interval=1000, log_interval=1, num_ckpt_keep=2)
    for stage, over in (("fs2", {}), ("diff", dict(
            fs2_ckpt=os.path.join(FLAGSHIP_DIR, "diff_params.npz")))):
        hp = load_hparams_json(os.path.join(FLAGSHIP_DIR, f"hparams_{stage}.json"),
                               dict(data, **over))
        with open(os.path.join(tmp, f"{stage}.json"), "w") as f:
            json.dump(hp, f)
    return binarize_cli(["--config", "fs2.json"], tmp, 8)


def prep_popcs(tmp):
    """Phase 12's PopCS corpus (POPCS_ITEMS items, seed 0) and its
    binarization (MidiSingingBinarizer)."""
    from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, "popcs")
    os.makedirs(root)
    make_synthetic_corpus(os.path.join(root, "raw"), n_items=POPCS_ITEMS, seed=0, fmt="popcs")
    return binarize_cli(["--config", os.path.join(repo, "configs", "usr", "popcs_fs2.yaml"),
                         "--hparams", popcs_data(root)], root, 8)


def prep_tts(tmp):
    """Phase 13's TextGrid corpus (TTS_ITEMS items, seed 0) and its
    binarization (the TextGrid binarizer, with_f0cwt)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, "tts")
    os.makedirs(root)
    write_textgrid_corpus(os.path.join(root, "raw"), TTS_ITEMS, seed=0)
    return binarize_cli(["--config", os.path.join(repo, "configs", "tts", "lj", "fs2.yaml"),
                         "--hparams", f"{tts_data(root)},binarizer_cls="
                         "bisinger_tpu.data.binarizer.ZhBinarizer"], root, 8)


def prep_paper(tmp):
    """Phase 16 (a) and the start of (b): `paper_corpora`, then each of its
    metas binarized by `run --binarize` with its config's binarizer
    (M4SingerBinarizer), the three at once, 3 processes each."""
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, "paper")
    os.makedirs(root)
    os.chdir(root)
    metas, lines, checks = paper_corpora(root)
    data = paper_data(root, metas)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "bisinger_tpu_torch.run", "--config",
         os.path.join(repo, "configs", "usr", "m4singer/fs2.yaml" if name != "les"
                      else "les-m4-nus/fs2.yaml"), "--binarize", "--hparams", data[name]],
        cwd=root, env=_binarize_env(3), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in metas}
    outs = {name: p.communicate(timeout=300)[0] for name, p in procs.items()}
    return dict(metas=metas, lines=lines, checks=checks, outs=outs,
                rcs={name: p.returncode for name, p in procs.items()},
                binarize_s=time.perf_counter() - t0)


def prep_variants(tmp):
    """Phase 17's binarizations (`variant_data`): phase 13's TextGrid corpus
    with speaker vectors and loud_norm, phase 10's corpus with trim_long_sil,
    the two at once, 4 processes each."""
    from concurrent.futures import ThreadPoolExecutor

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, "variants")
    os.makedirs(root)
    data = variant_data(tmp)
    argv = {"speech": ["--config", os.path.join(repo, "configs", "tts", "lj", "fs2.yaml"),
                       "--hparams", f"{data['speech']},binarizer_cls="
                       "bisinger_tpu.data.binarizer.ZhBinarizer"],
            "sing": ["--config", os.path.join(tmp, "fs2.json"), "--hparams", data["sing"]]}
    with ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(binarize_cli, a, root, 4) for name, a in argv.items()}
        return dict(runs={name: f.result() for name, f in futures.items()})


PREP_PARTS = (("training", prep_training), ("popcs", prep_popcs), ("tts", prep_tts),
              ("paper", prep_paper), ("variants", prep_variants))


def prepare(tmp: str) -> int:
    """`chip_smoke.py --prepare TMP`: PREP_PARTS in their order, each part's
    result to TMP/prep_<part>.json (its error instead, and the rest left
    out, where one raises)."""
    import signal
    import traceback

    os.nice(19)
    # the group, leading a POSIX session of its own, is orphaned: a member's exit while
    # Prep.paused holds the others stopped sends them all SIGHUP (then SIGCONT)
    signal.signal(signal.SIGHUP, signal.SIG_IGN)
    for part, fn in PREP_PARTS:
        started = time.time()
        try:
            res = fn(tmp)
        except Exception:
            res = dict(error=traceback.format_exc()[-3000:])
        res.update(started=started, ended=time.time())
        path = os.path.join(tmp, f"prep_{part}.json")
        with open(path + ".part", "w") as f:
            json.dump(res, f)
        os.replace(path + ".part", path)
        if "error" in res:
            return 1
    return 0


class Prep:
    """The `--prepare` process, started at once in a process group of its
    own (its log: checkpoints/chip_smoke/prep.log)."""

    def __init__(self, tmp):
        repo = os.path.dirname(os.path.abspath(__file__))
        out_dir = os.path.join(repo, "checkpoints", "chip_smoke")  # gitignored
        os.makedirs(out_dir, exist_ok=True)
        self.tmp, self.log_fn = tmp, os.path.join(out_dir, "prep.log")
        with open(self.log_fn, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--prepare", tmp],
                env=_binarize_env(1), stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)

    def wait(self, part, timeout=600.0):
        """`part`'s result, once written; `waited_s` the seconds this took."""
        fn = os.path.join(self.tmp, f"prep_{part}.json")
        t0 = time.perf_counter()
        while not os.path.exists(fn):
            if self.proc.poll() is not None and not os.path.exists(fn):
                with open(self.log_fn) as f:
                    raise RuntimeError(f"the host preparation ended (rc {self.proc.returncode})"
                                       f" before {part}: {f.read()[-2000:]}")
            if time.perf_counter() - t0 > timeout:
                raise RuntimeError(f"the host preparation of {part} took over {timeout:.0f} s")
            time.sleep(0.05)
        with open(fn) as f:
            res = json.load(f)
        if "error" in res:
            raise RuntimeError(f"the host preparation of {part} failed: {res['error']}")
        res["waited_s"] = time.perf_counter() - t0
        return res

    @staticmethod
    def when(res):
        return (f", in the background from {res['started'] - T_START_WALL:.1f} s to "
                f"{res['ended'] - T_START_WALL:.1f} s of the run, waited {res['waited_s']:.1f} s")

    def binarize_line(self, res, label, n_proc):
        counts = [ln for ln in res["stdout"].splitlines() if ln.startswith("| binarized")]
        warned = ("; Praat-AC fallback warned" if "parselmouth not installed" in res["stdout"]
                  else "")
        return (f"binarize{label}: {res['seconds']:.1f} s with {n_proc} processes"
                f"{self.when(res)} ({'; '.join(counts)}{warned})")

    @contextlib.contextmanager
    def paused(self):
        """The process group stopped (SIGSTOP) for the block, then resumed
        (SIGCONT): the fp32 steps on the CPU take several times as long
        beside its processes."""
        import signal

        running = self.proc.poll() is None
        if running:
            os.killpg(self.proc.pid, signal.SIGSTOP)
        try:
            yield
        finally:
            if running:
                try:
                    os.killpg(self.proc.pid, signal.SIGCONT)
                except ProcessLookupError:
                    pass

    def stop(self):
        """Ends the process and whatever it started."""
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGCONT)  # a stopped process takes no SIGTERM
            os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    prep = Prep(tmp)
    try:
        return run_phases(tmp, prep)
    finally:
        prep.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(tmp: str, prep: Prep) -> int:
    """Phases 1-20 in their order; `tmp` holds the corpora `prep` writes."""
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch, make_batch
    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch import native
    from bisinger_tpu_torch.ops import _build, _tf32, diffnet_stack, mrf_stage

    full_fp32()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    with Phase("1 device") as ph:
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
        ph.done(f"{kind}, {count} device(s); nvidia-smi: {smi}; torch {torch.__version__} "
                f"cuda {torch.version.cuda}")

    with Phase("2 build") as ph:
        # every instantiation, each kernel at each width it is built for: the
        # widths phases 3-20 launch first, the others in the background, at a
        # lower priority, joined before phase 21
        t0 = time.perf_counter()
        secs = _build.build_all(widths=FIRST_WIDTHS, log=log)
        for name, width in _build.targets(widths=FIRST_WIDTHS):
            _build.load(name, width)
        rest = {}

        def build_rest():
            try:
                rest["secs"] = _build.build_all(log=log, nice=10)
            except Exception as e:  # the joining phase fails with it
                rest["error"] = e

        rest_thread = threading.Thread(target=build_rest, daemon=True)
        rest_thread.start()
        ph.done(f"built {len(secs)} libraries in {time.perf_counter() - t0:.1f} s ("
                + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()) + ")"
                if secs else "libraries already built")

    C, L = 256, 20
    dils = [2 ** (i % 4) for i in range(L)]
    # each kernel route: (kernel, plain version, (max, mean) tolerance, input cast,
    # source, peak FLOP/s); the fp32 routes' max bound is near fp32 rounding and
    # needs no mean bound beside it
    k1_routes = {
        "fused_residual_stack": (
            diffnet_stack.residual_stack, diffnet_stack.residual_stack_plain,
            (diffnet_stack.TOLERANCE, None), lambda a: a, "diffnet_stack.cu", FP32_TC_PEAK),
        "fused_residual_stack_bf16": (
            diffnet_stack.residual_stack_bf16, diffnet_stack.residual_stack_plain_bf16,
            (diffnet_stack.TOLERANCE_BF16, diffnet_stack.MEAN_TOLERANCE_BF16), k1_bf16,
            "diffnet_stack_bf16.cu", BF16_PEAK),
    }
    k2_routes = {
        "fused_mrf_stage": (
            mrf_stage.mrf_stage, mrf_stage.mrf_stage_plain, (mrf_stage.TOLERANCE, None),
            torch.float32, "mrf_stage.cu", FP32_TC_PEAK),
        "fused_mrf_stage_bf16": (
            mrf_stage.mrf_stage_bf16, mrf_stage.mrf_stage_plain_bf16,
            (mrf_stage.TOLERANCE_BF16, mrf_stage.MEAN_TOLERANCE_BF16), torch.bfloat16,
            "mrf_stage_bf16.cu", BF16_PEAK),
    }
    # a control per route, read against the plain version. bf16: the plain
    # version with one rounding point moved; the mean bound must lie below its
    # reading. fp32: the plain version with single-pass TF32 products
    # (ops/_tf32.py); the kernel's relative max must lie at least 10x below
    # its reading, which shows that the kernel splits every operand (3xTF32)
    controls = {
        "fused_residual_stack": lambda *a: _tf32.residual_stack_plain_tf32(*a, passes=1),
        "fused_residual_stack_bf16": lambda *a: diffnet_stack.residual_stack_plain_bf16(
            *a, skip_dtype=torch.bfloat16),
        "fused_mrf_stage": lambda *a: _tf32.mrf_stage_plain_tf32(*a, passes=1),
        "fused_mrf_stage_bf16": lambda *a: mrf_stage.mrf_stage_plain_bf16(
            *a, conv1_dtype=torch.float32),
    }
    CONTROL_RATIO = 10.0

    def control_holds(name, rel, crel, cmean, tol=None):
        if name.endswith("_bf16"):
            tol = tol or (k1_routes.get(name) or k2_routes[name])[2]
            return cmean > tol[1]
        return rel * CONTROL_RATIO <= crel

    def control_text(name):
        return ("mean above the mean bound" if name.endswith("_bf16")
                else f"relative max {CONTROL_RATIO:g}x the kernel's")

    def outside(rel, mean, tol):
        return rel > tol[0] or (tol[1] is not None and mean > tol[1])

    def tol_text(tol):
        return f"{tol[0]:g}" + (f"/{tol[1]:g}" if tol[1] is not None else "/-")

    errs = {name: 0.0 for name in (*k1_routes, *k2_routes)}
    checked = {"K1": set(), "K2": set()}  # input shapes held against the plain versions
    with Phase("3 K1 vs plain") as ph:
        gen.manual_seed(1)
        args = k1_inputs(4, 256, C, L, gen, dev)
        checked["K1"].add((4, 256, C))
        lines, bad = [], []
        for name, (fn, plain, tol, cast, _, _) in k1_routes.items():
            a = cast(args)
            got = fn(*a, dils)
            torch.cuda.synchronize()
            ref = plain(*a, dils)
            err, rel, mean = rel_err(got, ref)
            errs[name] = max(errs[name], err)
            lines.append(f"{name} max_abs_err {err:.3e}, relative max {rel:.3e} mean {mean:.3e} "
                         f"(tolerance {tol_text(tol)})")
            if outside(rel, mean, tol):
                bad.append(name)
            _, crel, cmean = rel_err(controls[name](*a, dils), ref)
            lines.append(f"control: relative max {crel:.3e} mean {cmean:.3e} (must hold "
                         f"{control_text(name)})")
            if not control_holds(name, rel, crel, cmean):
                bad.append(f"{name} control")
        ph.done(f"B=4 T=256 C={C} L={L}: " + "; ".join(lines)
                + (f" MISMATCH {bad}" if bad else " ok"))
        if bad:
            return 1

    with Phase("4 K2 vs plain") as ph:
        rk, rd = [3, 7, 11], [[1, 3, 5]] * 3
        lines, bad = [], []
        for F in (256, 128, 64, 32):
            gen.manual_seed(F)
            x, w, b = k2_inputs(2, 2048, F, rk, rd, gen, dev)
            checked["K2"].add((2, 2048, F))
            for name, (fn, plain, tol, wdt, _, _) in k2_routes.items():
                wc = w.to(wdt)
                got = fn(x, wc, b, rk, rd)
                torch.cuda.synchronize()
                ref = plain(x, wc, b, rk, rd)
                err, rel, mean = rel_err(got, ref)
                errs[name] = max(errs[name], err)
                lines.append(f"{name} F={F} {err:.3e}/{rel:.3e}/{mean:.3e}")
                if outside(rel, mean, tol):
                    bad.append(f"{name} F={F}")
                _, crel, cmean = rel_err(controls[name](x, wc, b, rk, rd), ref)
                lines.append(f"control {crel:.3e}/{cmean:.3e}")
                if not control_holds(name, rel, crel, cmean):
                    bad.append(f"{name} F={F} control")
        ph.done(f"B=2 U=2048 max_abs_err/relative max/relative mean (tolerances "
                f"{tol_text(k2_routes['fused_mrf_stage'][2])} fp32, "
                f"{tol_text(k2_routes['fused_mrf_stage_bf16'][2])} bf16; each route's control "
                f"must hold: fp32 {control_text('fused_mrf_stage')} (single-pass TF32), bf16 "
                f"{control_text('fused_mrf_stage_bf16')} (conv1 unrounded)): " + "; ".join(lines)
                + (f" MISMATCH at {bad}" if bad else " ok"))
        if bad:
            return 1

    counters = {"fused_residual_stack": diffnet_stack.counter,
                "fused_residual_stack_bf16": diffnet_stack.counter_bf16,
                "fused_mrf_stage": mrf_stage.counter,
                "fused_mrf_stage_bf16": mrf_stage.counter_bf16}
    launches = {name: 0 for name in counters}  # phase 5's main paths
    by_path = {}  # each path's launches: path -> kernel -> count
    with Phase("5 path") as ph:
        svs32 = SVSInferTorch.from_checkpoint(FLAGSHIP_DIR, device=dev,
                                              hp_overrides=dict(compute_dtype="float32"))
        svs = SVSInferTorch.from_checkpoint(FLAGSHIP_DIR, device=dev)
        if svs.hp["compute_dtype"] != "bfloat16":
            ph.done(f"FAILED: the flagship runs compute_dtype {svs.hp['compute_dtype']}")
            return 1
        vocab = svs.vocab_size
        gen.manual_seed(0)
        batch = make_batch(4, 64, 256, vocab, seed=0)
        req = make_batch(1, 64, 256, vocab, seed=1)
        request = {"ph_token": req["txt_tokens"][0], "pitch_midi": req["pitch_midi"][0],
                   "midi_dur": req["midi_dur"][0], "is_slur": req["is_slur"][0],
                   "lang": req["lang"][0], "spk_id": int(req["spk_ids"][0]), "speechsing": 1}
        pred_batch = svs.items_to_batch([request], t_txt=64)
        n_calls = {"fused_residual_stack": svs.hp["K_step"] // svs.hp["pndm_speedup"] + 1,
                   "fused_mrf_stage": len(svs.hp["upsample_rates"])}
        n_calls.update({k + "_bf16": v for k, v in n_calls.items()})
        lines = []
        packs = diffnet_stack.pack_counter.launches
        for name, model, b, route in (("fp32, mel2ph given, B=4", svs32, batch, ""),
                                      ("bf16, mel2ph given, B=4", svs, batch, "_bf16"),
                                      ("bf16, predicted durations, B=1", svs, pred_batch, "_bf16")):
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.synthesize(b, generator=gen)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {k: c.launches for k, c in counters.items()}
            for k, v in counts.items():
                launches[k] += v
            by_path[f"5 {name}"] = counts
            # this route's kernels once per denoiser call and per vocoder stage, the
            # other route's never
            want = {k: n_calls[k] if k.endswith("_bf16") == (route == "_bf16") else 0
                    for k in counters}
            wav, mel = out["wav"], out["mel"]
            frames = mel.shape[1]
            voiced = int((out["mel2ph"] > 0).sum().item())
            checks = {
                "finite": bool(torch.isfinite(wav).all() and torch.isfinite(mel).all()),
                "non-silent": float(wav.abs().max()) > 1e-3,
                "length": tuple(wav.shape) == (mel.shape[0], frames * 128),
                "launches": counts == want,
            }
            lines.append(f"{name}: wav {tuple(wav.shape)} ({frames} frames, {voiced} filled), "
                         f"|wav| max {float(wav.abs().max()):.3f}, launches "
                         + ", ".join(f"{k} {v}" for k, v in counts.items())
                         + f", {secs:.2f} s, checks " + ",".join(k for k, v in checks.items() if v))
            if not all(checks.values()):
                ph.done(" | ".join(lines)
                        + f"; FAILED {[k for k, v in checks.items() if not v]}")
                return 1
        # the two bf16 calls (402 denoiser calls) take K1-bf16's narrow path,
        # which reads the weights unpacked (phase 7 counts the wide path's pack)
        packs = diffnet_stack.pack_counter.launches - packs
        lines.append(f"K1-bf16 weight packs over the bf16 calls: {packs} (the narrow path "
                     "takes none)")
        if packs != 0:
            ph.done(" | ".join(lines) + "; FAILED: the narrow path packed the weights")
            return 1
        # a small input with the random draws pinned: the fp32 path on the card
        # against the same path on the CPU (plain versions), and the bf16 path
        # against the fp32 path on the card
        small = make_batch(1, 16, 32, vocab, seed=2)
        g = torch.Generator().manual_seed(3)
        pins = dict(start_noise=torch.randn((1, 32, 80), generator=g),
                    nsf_phase=torch.rand((1, 9), generator=g),
                    nsf_noise=torch.randn((1, 32 * 128, 9), generator=g))
        pins_dev = {k: v.to(dev) for k, v in pins.items()}
        on_card = svs32.synthesize(small, **pins_dev)
        cpu = copy.copy(svs32)
        cpu.device = torch.device("cpu")
        cpu.model, cpu.pe, cpu.vocoder = (copy.deepcopy(m).cpu() for m in
                                          (svs32.model, svs32.pe, svs32.vocoder))
        on_cpu = cpu.synthesize(small, **pins)
        del cpu
        mel_err = rel_err(on_card["mel"].cpu(), on_cpu["mel"])[0]
        wav_err = rel_err(on_card["wav"].cpu(), on_cpu["wav"])[0]
        # the port's parity bounds against the JAX package (tests/test_torch_pipeline.py)
        small_ok = mel_err <= 1e-3 and wav_err <= 2e-3
        lines.append(f"fp32 card vs CPU on 16 tokens/32 frames: mel max err {mel_err:.3e} "
                     f"(tol 1e-3), wav max err {wav_err:.3e} (tol 2e-3) "
                     + ("ok" if small_ok else "MISMATCH"))
        # the JAX package's bf16 contract (tests/test_mixed_precision.py:77-81):
        # mean |difference| < 2% and max < 20% of the fp32 output's mean |value|,
        # on mel and f0 end to end, and on the waveform of the bf16 vocoder fed
        # the fp32 path's mel and f0. End to end the waveform is only reported:
        # the NSF source integrates f0 into the sine phase, so a 0.1% step of f0
        # moves later samples by a large part of their amplitude.
        on_card16 = svs.synthesize(small, **pins_dev)
        with torch.no_grad():
            voc16 = svs.vocoder(on_card["mel"], on_card["f0"], phase=pins_dev["nsf_phase"],
                                noise=pins_dev["nsf_noise"])
        contract = []
        for key, got, gate in (("mel", on_card16["mel"], True), ("f0", on_card16["f0"], True),
                               ("wav from fp32 mel/f0", voc16, True),
                               ("wav end to end", on_card16["wav"], False)):
            ref = on_card[key.split()[0]].double()
            diff = (got.double() - ref).abs()
            scale = ref.abs().mean().item()
            mean_r, max_r = diff.mean().item() / scale, diff.max().item() / scale
            ok = mean_r < 0.02 and max_r < 0.2
            if gate:
                contract.append(ok)
            lines.append(f"bf16 vs fp32 {key}: mean |diff| {100 * mean_r:.3f}%, max "
                         f"{100 * max_r:.3f}% of mean |fp32| {scale:.4g} "
                         + (("ok" if ok else "OUTSIDE") if gate else "(reported)"))
        ph.done(" | ".join(lines))
        if not (small_ok and all(contract)):
            return 1

    def cores_text(ms, flops, bytes_s):
        """An fp32 route's factor against the fp32 CUDA cores' bound too
        (67 TFLOP/s; the bound of the routes' first designs)."""
        bound = 1e3 * max(flops / FP32_PEAK, bytes_s)
        return f"; against the fp32 CUDA cores' bound {bound:.3f} ms, {ms / bound:.1f}x"

    kernels = []
    with Phase("6 kernels at the path's shapes") as ph:
        # the bench's shapes (phases 5 and 7): outputs held against the plain
        # versions on the same inputs, then timed
        lines, bad = [], []
        for name, (fn, plain, tol, cast, src, peak) in k1_routes.items():
            row = {}
            for B, T, reps in ((4, 256, 20), (32, 1024, 2)):
                gen.manual_seed(5 + B)
                a = cast(k1_inputs(B, T, C, L, gen, dev))
                checked["K1"].add((B, T, C))
                got = fn(*a, dils)
                ref = plain(*a, dils)
                err, rel, mean = rel_err(got, ref)
                errs[name] = max(errs[name], err)
                if outside(rel, mean, tol):
                    bad.append(f"{name} B={B} T={T}")
                _, crel, cmean = rel_err(controls[name](*a, dils), ref)
                if not control_holds(name, rel, crel, cmean):
                    bad.append(f"{name} B={B} T={T} control")
                del got, ref
                ms = cuda_ms(lambda: fn(*a, dils), reps=reps)
                plain_ms = cuda_ms(lambda: plain(*a, dils), reps=reps)
                # the same stack as cuDNN conv1d and cuBLAS products, in the route's dtype
                ldt = a[0].dtype
                lib_err = rel_err(diffnet_stack.residual_stack_library(*a, dils, dtype=ldt),
                                  plain(*a, dils))[1]
                lib = cuda_ms(lambda: diffnet_stack.residual_stack_library(*a, dils, dtype=ldt),
                              reps=reps)
                flops = diffnet_stack.stack_flops(B, T, C, L)
                fl = flops / peak
                by = diffnet_stack.stack_bytes(B, T, C, L, bf16=peak == BF16_PEAK) / HBM_RATE
                bound = 1e3 * max(fl, by)
                del a
                lines.append(f"{name} B={B} T={T}: {ms:.3f} ms (plain {plain_ms:.3f}, library "
                             f"chain {lib:.3f} (relative max err {lib_err:.2e}), bound "
                             f"{bound:.3f} by {'operations' if fl >= by else 'bytes'}, "
                             f"{ms / bound:.1f}x{cores_text(ms, flops, by) if peak == FP32_TC_PEAK else ''}), err "
                             f"{err:.3e}/{rel:.3e}/{mean:.3e}, control {crel:.3e}/{cmean:.3e}")
                if B == 4:
                    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, library_ms=lib,
                               bound_by="operations" if fl >= by else "bytes")
            kernels.append(dict(
                name=name, route="cuda", source=f"bisinger_tpu_torch/csrc/{src}",
                replaces="bisinger_tpu/ops/diffnet_pallas.py:214", launches=None,
                max_abs_err=errs[name], ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"]))
        hp = svs.hp
        rk, rd = hp["resblock_kernel_sizes"], hp["resblock_dilation_sizes"]
        for name, (fn, plain, tol, wdt, src, peak) in k2_routes.items():
            row = {}
            for B, T, reps in ((4, 256, 5), (32, 1024, 1)):
                tot = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0, fl=0.0, by=0.0, flops=0,
                           bytes_s=0.0)
                stages = []
                F, U = hp["upsample_initial_channel"], T
                for u in hp["upsample_rates"]:
                    F, U = F // 2, U * u
                    x, w, b = k2_inputs(B, U, F, rk, rd, gen, dev)
                    checked["K2"].add((B, U, F))
                    w = w.to(wdt)
                    got = fn(x, w, b, rk, rd)
                    ref = plain(x, w, b, rk, rd)
                    err, rel, mean = rel_err(got, ref)
                    errs[name] = max(errs[name], err)
                    if outside(rel, mean, tol):
                        bad.append(f"{name} B={B} U={U} F={F}")
                    _, crel, cmean = rel_err(controls[name](x, w, b, rk, rd), ref)
                    if not control_holds(name, rel, crel, cmean):
                        bad.append(f"{name} B={B} U={U} F={F} control")
                    del got, ref
                    ms = cuda_ms(lambda: fn(x, w, b, rk, rd), reps=reps)
                    plain_ms = cuda_ms(lambda: plain(x, w, b, rk, rd), reps=reps)
                    # the same chain of conv1d calls in the route's dtype (cuDNN)
                    lib = cuda_ms(lambda: mrf_stage.mrf_stage_conv1d(x, w, b, rk, rd, dtype=wdt),
                                  reps=reps)
                    del x, w, b
                    flops = mrf_stage.stage_flops(B, U, F, rk, rd)
                    fl = flops / peak
                    by = mrf_stage.stage_bytes(B, U, F, rk, rd, bf16=wdt == torch.bfloat16) \
                        / HBM_RATE
                    bound = 1e3 * max(fl, by)
                    for key, v in (("ms", ms), ("plain", plain_ms), ("lib", lib),
                                   ("bound", bound), ("fl", fl), ("by", by), ("flops", flops),
                                   ("bytes_s", by)):
                        tot[key] += v
                    stages.append(f"F={F} U={U} {ms:.3f} ms (plain {plain_ms:.3f}, conv1d "
                                  f"{lib:.3f}, bound {bound:.3f}), "
                                  f"err {err:.3e}/{rel:.3e}/{mean:.3e}, control "
                                  f"{crel:.3e}/{cmean:.3e}")
                cores = cores_text(tot["ms"], tot["flops"], tot["bytes_s"]) \
                    if peak == FP32_TC_PEAK else ""
                lines.append(f"{name} B={B} T={T}, one vocoder pass {tot['ms']:.3f} ms (plain "
                             f"{tot['plain']:.3f}, conv1d {tot['lib']:.3f}, bound "
                             f"{tot['bound']:.3f}, {tot['ms'] / tot['bound']:.1f}x{cores}): "
                             + "; ".join(stages))
                if B == 4:
                    row = dict(ms=tot["ms"], plain_ms=tot["plain"], bound_ms=tot["bound"],
                               library_ms=tot["lib"],
                               bound_by="operations" if tot["fl"] >= tot["by"] else "bytes")
            kernels.append(dict(
                name=name, route="cuda", source=f"bisinger_tpu_torch/csrc/{src}",
                replaces="bisinger_tpu/ops/mrf_pallas.py:366", launches=None,
                max_abs_err=errs[name], ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"]))
        ph.done("tolerances (relative max/mean) K1 "
                + ", ".join(tol_text(r[2]) for r in k1_routes.values()) + "; K2 "
                + ", ".join(tol_text(r[2]) for r in k2_routes.values())
                + " (fp32, bf16); errors max_abs/relative max/relative mean | "
                + " | ".join(lines)
                + (f"; MISMATCH at {bad}" if bad else "; ok"))
        if bad:
            return 1

    with Phase("7 path times") as ph:
        # warm synthesize() wall times, ending in a synchronize; audio seconds
        # made per second at 24 kHz, hop 128
        lines = []
        packs = 0  # K1-bf16 weight packs over the bf16 B=32 call
        for B, T, warm in ((4, 256, True), (32, 1024, False)):
            b = make_batch(B, 64, T, vocab, seed=B)
            for label, model in (("bf16", svs), ("fp32", svs32)):
                reps = 2 if warm else 1
                before = diffnet_stack.pack_counter.launches
                if warm:
                    model.synthesize(b, generator=gen)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    model.synthesize(b, generator=gen)
                torch.cuda.synchronize()
                secs = (time.perf_counter() - t0) / reps
                if label == "bf16" and B == 32:
                    packs = diffnet_stack.pack_counter.launches - before
                audio = B * T * 128 / 24000
                lines.append(f"{label} B={B} T={T}: {secs:.3f} s per call, "
                             f"{audio / secs:.2f} audio-s/s"
                             + ("" if warm else " (first call at this shape)"))
        # 201 denoiser calls on K1-bf16's wide path, one pack of the weights
        lines.append(f"K1-bf16 weight packs over the bf16 B=32 call: {packs} (one per set of "
                     "parameters)")
        if packs != 1:
            ph.done("; ".join(lines) + "; FAILED: the weights were not packed once")
            return 1
        ph.done("; ".join(lines))

    with Phase("8 score entry points") as ph:
        ok = score_entry_points(svs32, counters, by_path, n_calls, dev)
        ph.done("ok" if ok else "FAILED")
        if not ok:
            return 1

    record = {}  # phase 10's step-1 losses, for phase 14
    with Phase("10 training") as ph:
        ok, lines = training_phase(svs, counters, by_path, dev, tmp, record, prep)
        ph.done(" | ".join(lines))
        if not ok:
            return 1
    with Phase("11 cascade training") as ph:
        ok, lines = cascade_phase(svs, counters, by_path, dev, tmp, prep)
        ph.done(" | ".join(lines))
        if not ok:
            return 1
    with Phase("12 PopCS family from the YAML configs") as ph:
        ok, lines = popcs_phase(counters, by_path, dev, tmp, smi, prep)
        ph.done(" | ".join(lines))
        if not ok:
            return 1
    with Phase("13 TTS: DiffSpeech from the LJSpeech configs") as ph:
        ok, lines = tts_phase(counters, by_path, dev, tmp, smi, prep)
        ph.done(" | ".join(lines))
        if not ok:
            return 1
    # phase 14's launches run beside phases 15-17 (their host work and the card's
    # are far from full alone); its checks come after 17
    with Phase("14 data parallel, started") as ph:
        started = dp_start(svs, dev, tmp)
        ph.done("the fp32 step in this process taken; torchrun launches started")
    try:
        with Phase("15 vocoder family") as ph:
            ok, lines = vocoder_phase(svs, counters, by_path, dev, tmp, smi)
            ph.done(" | ".join(lines))
            if not ok:
                return 1
        with Phase("16 the paper's recipe") as ph:
            ok, lines = paper_phase(counters, by_path, dev, tmp, smi, prep)
            ph.done(" | ".join(lines))
            if not ok:
                return 1
        with Phase("17 the model and data variants") as ph:
            ok, lines = variants_phase(counters, by_path, dev, tmp, smi, prep)
            ph.done(" | ".join(lines))
            if not ok:
                return 1
        with Phase("14 data parallel") as ph:
            ok, lines = dp_phase(started, svs, counters, by_path, dev, tmp, record)
            # the datasets of phases 11-17, read through the native codec
            n = native.counter.records
            lines.append(f"records decoded natively since phase 10's stages: {n}")
            ph.done(" | ".join(lines))
            if not ok or n == 0:
                return 1
    finally:
        started[0].stop()

    # phases 19's and 20's launches run beside phase 18; their checks come after 18
    with Phase("19 and 20 sequence, pipeline and tensor parallel, started") as ph:
        par = par_start(svs, dev, tmp)
        ph.done("inputs written; torchrun launches started")
    try:
        with Phase("18 work dirs served, and the tools") as ph:
            ok, lines = work_dirs_phase(counters, by_path, dev, tmp, smi)
            ph.done(" | ".join(lines))
            if not ok:
                return 1
        ranks, failed, waited = par_wait(par, counters, tmp)
        with Phase("19 sequence and pipeline parallel") as ph:
            ok, lines = par_phase(par, ranks, failed, waited, svs, svs32, by_path, dev, tmp)
            ph.done(" | ".join(lines))
            if not ok:
                return 1
        with Phase("20 tensor parallel") as ph:
            ok, lines = tp_phase(ranks, failed, by_path, tmp)
            ph.done(" | ".join(lines))
            if not ok:
                return 1
    finally:
        par.stop()

    with Phase("2 build, the other widths (in the background since phase 2)") as ph:
        t0 = time.perf_counter()
        rest_thread.join()
        if "error" in rest:
            ph.done(f"FAILED: {rest['error']}")
            return 1
        for name, width in _build.targets():
            _build.load(name, width)
        ph.done(f"built {len(rest['secs'])} libraries (waited {time.perf_counter() - t0:.1f} "
                "s here): " + ", ".join(f"{n} {s:.1f} s" for n, s in rest["secs"].items()))

    # the bf16 kernels launched back to back (K1-bf16's wide and narrow
    # paths, K2-bf16's F=256 stage at both batches, and the layouts of other
    # widths) in a child process that is killed if it has not ended: a barrier
    # never released hangs a launch, possibly once in hundreds (an mbarrier
    # ring of K2's deadlocked within 50 to 200). It runs beside phases 21 and
    # 9, which time nothing that the kernels line reports
    from bisinger_tpu_torch.tools import repeat_launch
    repeat = repeat_launch.start(REPEAT_LAUNCHES)
    try:
        with Phase("21 the kernels at the JAX scripts' widths, and remat") as ph:
            ok, lines = widths_phase(counters, by_path, dev, tmp, smi)
            ph.done(" | ".join(lines))
            if not ok:
                return 1

        with Phase("9 kernels at every shape launched") as ph:
            # the input shapes any phase launched a kernel on (phases 5 and 8 at
            # their batch and frame buckets) that phases 3, 4 and 6 did not check:
            # both routes of each kernel against their plain versions there, with
            # every route's control
            shapes = {"K1": set().union(counters["fused_residual_stack"].shapes,
                                        counters["fused_residual_stack_bf16"].shapes),
                      "K2": set().union(counters["fused_mrf_stage"].shapes,
                                        counters["fused_mrf_stage_bf16"].shapes)}
            lines, bad = [], []
            # a write-last launch (a pipeline stage's) records its dilations too: both
            # routes in that mode, the skip and the last layer's x held
            for shape in sorted(shapes["K1"] - checked["K1"]):
                B, T, Cs = shape[:3]
                d = list(shape[3]) if len(shape) == 4 else dils
                wl = dict(write_last=True) if len(shape) == 4 else {}
                where = f"B={B} T={T} C={Cs}" + (f" L={len(d)} write-last" if wl else "")
                gen.manual_seed(7 + B + T + Cs + len(d))
                args = k1_inputs(B, T, Cs, len(d), gen, dev)
                for name, (fn, plain, tol, cast, _, _) in k1_routes.items():
                    if tol[1] is not None:  # the bf16 mean bound, for a stack of len(d) layers
                        tol = (tol[0], diffnet_stack.mean_tolerance_bf16(len(d)))
                    a = cast(args)
                    got, ref = fn(*a, d, **wl), plain(*a, d, **wl)
                    pairs = [(got[0], ref[0]), (got[1].float(), ref[1].float())] if wl else \
                        [(got, ref)]
                    text = f"{name} {where}"
                    for (g, r), part in zip(pairs, ("", " x_last")):
                        err, rel, mean = rel_err(g, r)
                        errs[name] = max(errs[name], err)
                        text += f"{part} {err:.3e}/{rel:.3e}/{mean:.3e}"
                        if outside(rel, mean, tol):
                            bad.append(f"{name} {where}{part}")
                        if not part:
                            skip_rel = rel
                    _, crel, cmean = rel_err(controls[name](*a, d), pairs[0][1])
                    text += f" (control {crel:.3e}/{cmean:.3e})"
                    if not control_holds(name, skip_rel, crel, cmean, tol):
                        bad.append(f"{name} {where} control")
                    lines.append(text)
            for B, U, F in sorted(shapes["K2"] - checked["K2"]):
                gen.manual_seed(11 + B + U + F)
                x, w, b = k2_inputs(B, U, F, rk, rd, gen, dev)
                for name, (fn, plain, tol, wdt, _, _) in k2_routes.items():
                    if tol[1] is not None:  # the bf16 mean bound of a stage of width F
                        tol = (tol[0], mrf_stage.mean_tolerance_bf16(F))
                    wc = w.to(wdt)
                    ref = plain(x, wc, b, rk, rd)
                    err, rel, mean = rel_err(fn(x, wc, b, rk, rd), ref)
                    errs[name] = max(errs[name], err)
                    text = f"{name} B={B} U={U} F={F} {err:.3e}/{rel:.3e}/{mean:.3e}"
                    if outside(rel, mean, tol):
                        bad.append(f"{name} B={B} U={U} F={F}")
                    _, crel, cmean = rel_err(controls[name](x, wc, b, rk, rd), ref)
                    text += f" (control {crel:.3e}/{cmean:.3e})"
                    if not control_holds(name, rel, crel, cmean, tol):
                        bad.append(f"{name} B={B} U={U} F={F} control")
                    lines.append(text)
                del x, w, b
            ph.done(f"{len(shapes['K1'] - checked['K1'])} K1 and "
                    f"{len(shapes['K2'] - checked['K2'])} K2 shapes beyond phases 3, 4 and 6; "
                    "max_abs_err/relative max/relative mean (tolerances as phase 6; K1-bf16's mean "
                    f"bound at a pipeline stage's 4 layers 4/20 of it: "
                    f"{diffnet_stack.mean_tolerance_bf16(4):g}): "
                    + "; ".join(lines) + (f"; MISMATCH at {bad}" if bad else "; ok"))
            if bad:
                return 1

        with Phase("6 repeat launches (in a child beside phases 21 and 9)") as ph:
            rep_ok, rep, rep_msg = repeat_launch.finish(repeat, REPEAT_TIMEOUT_S, log=log)
            ph.done(f"{REPEAT_LAUNCHES + 1} launches each case, the child killed "
                    f"{REPEAT_TIMEOUT_S:.0f} s after its start: {rep_msg}; "
                    + ", ".join(f"{r['kernel']} B={r['B']} T={r['T']} width {r['width']} "
                                f"{r['seconds']:.2f} s"
                                + ("" if r["bit_identical"] else " DIFFERS")
                                + (f" error {r['error']}" if r["error"] else "") for r in rep))
            if not rep_ok:
                return 1
    finally:
        if repeat[0].poll() is None:
            repeat[0].kill()
            repeat[0].communicate()

    total = time.perf_counter() - T_START
    log(f"[total] {total:.1f} s (budget {BUDGET_S:.0f} s, target 300 s)")
    if total > BUDGET_S:
        return 1
    log(smi)  # the card and its power limit, as nvidia-smi gives them
    for row in kernels:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = {path: c[row["name"]] for path, c in by_path.items()}
        # the widths (K1's C, K2's F) of every launch since the start
        row["widths_launched"] = sorted({int(sh[2]) for sh in counters[row["name"]].shapes})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--prepare":
        sys.exit(prepare(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] in ("--dp-gloo", "--dp-nccl"):
        sys.exit(dp_ranks(sys.argv[2], nccl=sys.argv[1] == "--dp-nccl"))
    if len(sys.argv) == 3 and sys.argv[1] in ("--par-sp", "--par-pp", "--par-tp"):
        sys.exit({"--par-sp": sp_ranks, "--par-pp": pp_ranks,
                  "--par-tp": tp_ranks}[sys.argv[1]](sys.argv[2]))
    if sys.argv[1:] == ["--par-only"]:
        sys.exit(par_only())
    sys.exit(main())
