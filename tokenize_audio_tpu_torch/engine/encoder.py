"""Length-bucketed Mimi batch-encode engine on one GPU.

Drop-in capability replacement for the reference's ``MimiEncoder`` wrapper
(yodas2-mimi/process_shard.py:185-274 and its nine copy-paste sites):

  - ``encode_chunk(audio, sr)``  — one utterance -> (K, T) codes, splitting
    >60 s audio into independently-encoded pieces concatenated on the time
    axis (reference policy, process_shard.py:436-493).
  - ``encode_batch(audios, sr)`` — many utterances -> list of (K, T) codes,
    trimmed to ceil(len/1920) frames each (process_shard.py:262-274).

Differences from the reference:
  - pad-to-bucket over a static shape lattice instead of pad-to-longest;
  - masked padding semantics make every utterance's codes bit-identical to
    its standalone encode — batch composition cannot change codes;
  - polyphase resampling on the device instead of host librosa;
  - up to ``pipeline_depth`` batches in flight: each batch launches on the
    current CUDA stream and its codes are copied to pinned host memory
    with ``non_blocking=True`` behind a recorded event, so padding the next
    batch overlaps the device work of the previous ones.

Not ported yet: a device mesh / multi-GPU, ``long_audio_policy="stream"``,
the "ready"/"threaded" drains and autotuning (each raises
NotImplementedError when asked for), and transient-fault retry.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.core.audio import (
    bucket_for_length,
    make_buckets,
    pad_to_bucket,
    pcm_to_float,
    resample,
    resample_many,
    split_long_audio_with_context,
)
from tokenize_audio_tpu_torch.engine.metrics import EngineStats
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
from tokenize_audio_tpu_torch.mimi.model import encode as mimi_encode
from tokenize_audio_tpu_torch.mimi.weights import params_to_torch

logger = logging.getLogger(__name__)


def _prune_for_encode(params, num_codebooks: int):
    """Drop the param subtrees the encode path never touches: the decoder
    stack (dec/dec_tfm/upsample), RVQ output projections, and acoustic
    codebooks beyond the requested depth."""
    keep = {
        k: v
        for k, v in params.items()
        if k in ("enc_in", "blocks", "enc_out", "tfm", "downsample", "rvq")
    }
    rvq = {}
    for head in ("semantic", "acoustic"):
        h = dict(params["rvq"][head])
        h.pop("out_proj", None)
        rvq[head] = h
    n_sem = rvq["semantic"]["embed"].shape[0]
    n_ac = max(0, num_codebooks - n_sem)
    rvq["semantic"]["embed"] = rvq["semantic"]["embed"][: min(n_sem, num_codebooks)]
    rvq["acoustic"]["embed"] = rvq["acoustic"]["embed"][:n_ac]
    keep["rvq"] = rvq
    return keep


class MimiEncoderEngine:
    def __init__(
        self,
        params,
        cfg: Optional[MimiConfig] = None,
        engine_cfg: Optional[EngineConfig] = None,
        mesh=None,
        num_codebooks: Optional[int] = None,
        masked: bool = True,
        # in-flight device batches: bounds pinned host and device memory
        # while overlapping host padding with device work. Depth is
        # transport-only — numerics are unaffected.
        pipeline_depth: int = 18,
        device: Optional[str | torch.device] = None,
    ):
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError("the port's engine runs on one device (no mesh)")
        self.pipeline_depth = pipeline_depth
        self.cfg = cfg or MimiConfig()
        self.engine_cfg = engine_cfg or EngineConfig()
        self.num_codebooks = num_codebooks or self.engine_cfg.num_codebooks
        self.masked = masked
        self.stats = EngineStats()
        self._bucket_cache: dict = {}
        self.buckets = self._buckets_for(
            self.engine_cfg.sample_rate, self.cfg.samples_per_frame
        )
        fmt = self.engine_cfg.code_transfer_format
        if fmt not in ("padded", "packed", "compact"):
            raise ValueError(f"unknown code_transfer_format {fmt!r}")
        if self.engine_cfg.drain_policy not in ("fifo", "ready", "threaded"):
            raise ValueError(
                f"unknown drain_policy {self.engine_cfg.drain_policy!r}"
            )
        if self.engine_cfg.drain_policy != "fifo":
            raise NotImplementedError(
                f"drain_policy {self.engine_cfg.drain_policy!r} is not ported; use 'fifo'"
            )
        if self.engine_cfg.long_audio_policy != "split":
            raise NotImplementedError(
                f"long_audio_policy {self.engine_cfg.long_audio_policy!r} is not "
                "ported; use 'split'"
            )
        if fmt != "padded" and self.num_codebooks % 2 != 0:
            if fmt == "compact":
                # compact is always an explicit opt-in (the default is
                # packed); refuse instead of silently downgrading
                raise ValueError(
                    f"compact transfer packs code pairs; num_codebooks "
                    f"{self.num_codebooks} must be even"
                )
            # pair packing needs even K; an odd-codebook engine (e.g.
            # semantic-only K=1) must keep working under the packed
            # DEFAULT, so fall back instead of raising
            logger.warning(
                "code_transfer_format='packed' packs code pairs but "
                "num_codebooks %d is odd; falling back to 'padded'",
                self.num_codebooks,
            )
            self.engine_cfg = dataclasses.replace(
                self.engine_cfg, code_transfer_format="padded"
            )
        if self.engine_cfg.code_transfer_format == "compact" and not self.masked:
            raise ValueError("compact transfer requires masked=True")
        # pruned params live on the device for the engine's lifetime: the
        # decoder stack and unused acoustic codebooks are ~half the
        # checkpoint and the encode path never reads them
        self.params = params_to_torch(
            _prune_for_encode(params, self.num_codebooks), self.device
        )

    # -- internals ---------------------------------------------------------

    def _buckets_for(self, domain_sr: int, spf_io: int):
        """Bucket lattice in ``domain_sr``-samples (the fused-resample path
        buckets at the SOURCE rate so frames stay aligned end to end)."""
        key = (domain_sr, spf_io)
        if key not in self._bucket_cache:
            self._bucket_cache[key] = make_buckets(
                self.engine_cfg.min_bucket_seconds,
                self.engine_cfg.max_chunk_seconds
                + self.engine_cfg.split_context_seconds,
                self.engine_cfg.bucket_growth,
                domain_sr,
                spf_io,
            )
        return self._bucket_cache[key]

    def _dispatch(
        self,
        utterances: Sequence[np.ndarray],
        bucket: int,
        resample_arg: "Optional[tuple]" = None,
        budget_len: Optional[int] = None,
    ):
        """Pad one device batch and launch its encode. Returns the in-flight
        handle ``(host_codes, event, n_real, frames, bucket_frames)`` —
        per-row frame counts are HOST-computed (no device valid fetch), and
        ``host_codes``' layout depends on code_transfer_format.
        ``resample_arg`` = (up, down) for the fused on-device resample (rows
        are at the source rate); ``budget_len`` is the POST-resample length
        used for the activation-memory samples budget (defaults to bucket)."""
        group = list(utterances)
        n_real = len(group)
        # tail-ladder batch size >= n_real (bounded set of batch shapes,
        # minimal padded-row waste — see EngineConfig.batch_size_for_group)
        bs = self.engine_cfg.batch_size_for_group(
            budget_len if budget_len is not None else bucket, n_real
        )
        # pad rows match the group's dtype so an all-int16 group keeps the
        # narrow-transfer fast path (pad_to_bucket falls back to f32 on mix)
        pad_dtype = group[0].dtype if group else np.float32
        group += [np.zeros(1, dtype=pad_dtype)] * (bs - n_real)
        fmt = self.engine_cfg.code_transfer_format
        with self.stats.stage("pad"):
            batch, lengths = pad_to_bucket(group, bucket)
        # per-row frame counts are host-derivable (the ceil-division chain
        # through the conv strides equals one ceil by samples_per_frame, and
        # the fused resample's valid update is the same ceil) — so no mode
        # ever fetches the device `valid` array
        spf = self.cfg.samples_per_frame
        res_len = lengths.astype(np.int64)
        if resample_arg is not None:
            up, down = resample_arg
            res_len = -((-res_len * up) // down)
        frames = (-(-res_len // spf)).astype(np.int64)
        with self.stats.stage("dispatch"):
            b = torch.from_numpy(batch).to(self.device)
            v = torch.from_numpy(lengths).to(self.device)
            codes, _ = mimi_encode(
                self.params,
                self.cfg,
                b,
                v,
                num_quantizers=self.num_codebooks,
                masked=self.masked,
                code_dtype=self.engine_cfg.code_transfer_dtype,
                resample=resample_arg,
                transfer=fmt,
            )
            # frames per padded row = bucket / samples-per-frame in the
            # I/O domain (source-rate when the fused resample is active)
            io_spf = spf if resample_arg is None else spf * down // up
            bucket_frames = bs * int(-(-bucket // io_spf))
            if fmt == "compact":
                # copy only the valid-frame prefix, padded UP to a 16-step
                # lattice of the buffer size (<=1/16 overfetch)
                total = int(frames.sum())
                cap = codes.shape[0]
                step = max(1, cap // 16)
                codes = codes[: min(cap, -(-total // step) * step)]
            # queue the device->host copy now, behind the encode on the same
            # stream: it starts the moment compute finishes, and _collect
            # waits on the event instead of synchronizing the device
            event = None
            if self.device.type == "cuda":
                host = torch.empty(codes.shape, dtype=codes.dtype, pin_memory=True)
                host.copy_(codes, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            else:
                host = codes
        return host, event, n_real, frames, bucket_frames

    def _collect(self, handle) -> List[np.ndarray]:
        """Wait for an in-flight batch and trim per-row codes."""
        host, event, n_real, frames, bucket_frames = handle
        fmt = self.engine_cfg.code_transfer_format
        dtype = np.dtype(self.engine_cfg.code_transfer_dtype)
        with self.stats.stage("fetch"):
            if event is not None:
                event.synchronize()
            codes = host.numpy()
        out = []
        n_frames = 0
        if fmt == "padded":
            for i in range(n_real):
                f = int(frames[i])
                # copy: a trimmed VIEW would pin the whole (B, K, T_bucket)
                # batch buffer for as long as a caller keeps one row's codes
                out.append(codes[i, :, :f].copy())
                n_frames += f
        elif fmt == "packed":
            # packed modes: int32 words -> exact uint16 code stream via a
            # zero-copy little-endian view (pairs pack low|high<<16)
            u16 = np.ascontiguousarray(codes).view("<u2")
            u16 = u16.reshape(codes.shape[0], codes.shape[1], -1)  # (B, T, K)
            for i in range(n_real):
                f = int(frames[i])
                out.append(u16[i, :f].T.astype(dtype))
                n_frames += f
        else:
            # compact: prefix rows are valid frames in row order
            u16 = np.ascontiguousarray(codes).view("<u2")
            u16 = u16.reshape(codes.shape[0], -1)  # (rows, K)
            off = 0
            for i in range(n_real):
                f = int(frames[i])
                out.append(u16[off : off + f].T.astype(dtype))
                n_frames += f
                off += f
        with self.stats._lock:
            self.stats.frames += n_frames
            self.stats.padded_frames += bucket_frames
        return out

    def _prepare_mono(self, audio: np.ndarray) -> np.ndarray:
        """Mixdown/flatten only — no resample, int16 preserved (non-24 kHz
        input then resamples on device: fused into the encode, or via
        resample_many for the unmasked/exotic-rate fallback)."""
        audio = np.asarray(audio)
        if audio.ndim == 2:
            ch_axis = int(np.argmin(audio.shape))
            if audio.shape[ch_axis] > 8:
                raise ValueError(
                    f"ambiguous multichannel audio shape {audio.shape}; pass "
                    "mono (T,) or channels on the small axis (<= 8)"
                )
            audio = pcm_to_float(audio).mean(axis=ch_axis)
        return audio.reshape(-1)

    def _prepare(self, audio: np.ndarray, sr: int) -> np.ndarray:
        audio = self._prepare_mono(audio)
        if sr != self.engine_cfg.sample_rate:
            audio = pcm_to_float(audio)
            with self.stats.stage("resample"):
                audio = (
                    resample(audio, sr, self.engine_cfg.sample_rate, device=self.device)
                    .cpu()
                    .numpy()
                )
        elif audio.dtype != np.int16:
            # mono int16 PCM at the engine rate ships to the device raw:
            # pad_to_bucket keeps it int16 and the model normalizes on
            # device (exact x/32768) — half the host->device bytes.
            # Everything else normalizes here.
            audio = pcm_to_float(audio)
        return audio

    # public alias: normalize + resample to the engine sample rate
    prepare_audio = _prepare

    def _resample_plan(self, sr: int):
        """How audio at ``sr`` reaches the model: returns
        (resample_arg, spf_io, domain_sr) where ``resample_arg`` is the
        (up, down) of the FUSED on-device resample (None = no fuse: already
        at engine rate, exotic rate, or unmasked semantics), ``spf_io`` the
        samples-per-frame in the I/O domain, and ``domain_sr`` the rate
        bucketing/splitting run at. Shared by encode_batch and warmup so
        the lattice/plan can never diverge."""
        rate = self.engine_cfg.sample_rate
        if sr != rate:
            g = math.gcd(int(sr), int(rate))
            up, down = rate // g, sr // g
            if self.masked and (self.cfg.samples_per_frame * down) % up == 0:
                return (up, down), self.cfg.samples_per_frame * down // up, sr
        return None, self.cfg.samples_per_frame, rate

    # -- public API --------------------------------------------------------

    def encode_batch(
        self, audios: Sequence[np.ndarray], sr: int = 24_000, defer: bool = False
    ):
        """Encode utterances; returns per-utterance (num_codebooks, frames)
        integer arrays (EngineConfig.code_transfer_dtype, default int32) in
        input order. Audio longer than the 60 s cap is split and
        re-concatenated on the code time axis.

        ``defer=True`` returns a zero-arg ``finish()`` closure instead of
        the result list: every batch is already launched (depth-bounded),
        but the tail drain and reassembly run only when ``finish()`` is
        called, from any single thread, so a caller that collects in a
        worker thread keeps the device busy across calls. Call each
        finish() exactly once; results are bit-identical to the eager
        path."""
        rate = self.engine_cfg.sample_rate
        resample_arg, spf_io, domain_sr = self._resample_plan(sr)
        if resample_arg is not None:
            # FUSED on-device resample: ship source-rate PCM (int16 stays
            # int16) and resample inside the encode; bucketing/splitting
            # run in source samples, frame-aligned via the integer
            # source-samples-per-frame
            up, down = resample_arg
            prepared = [self._prepare_mono(a) for a in audios]
        elif sr != rate:
            # non-integer source frame (exotic rate) or unmasked HF
            # semantics: batched device resample, then the 24 kHz path
            raw = [self._prepare_mono(a) for a in audios]
            with self.stats.stage("resample"):
                prepared = resample_many(raw, sr, rate, device=self.device)
        else:
            prepared = [self._prepare(a, sr) for a in audios]
        buckets = self._buckets_for(domain_sr, spf_io)
        # explode >cap audio into pieces, remembering the mapping
        pieces: List[np.ndarray] = []
        piece_of: List[int] = []
        piece_drop: List[int] = []  # leading context frames to discard
        cap = int(self.engine_cfg.max_chunk_seconds * domain_sr)
        ctx = int(self.engine_cfg.split_context_seconds * domain_sr)
        for i, a in enumerate(prepared):
            self.stats.audio_seconds += len(a) / domain_sr
            self.stats.utterances += 1
            for p, drop in split_long_audio_with_context(a, cap, ctx, spf_io):
                pieces.append(p)
                piece_of.append(i)
                piece_drop.append(drop)

        # group by bucket and chunk into device batches
        order = sorted(range(len(pieces)), key=lambda j: len(pieces[j]))
        jobs: List[tuple] = []  # (bucket, budget_len, [piece indices])
        j = 0
        while j < len(order):
            bucket = bucket_for_length(len(pieces[order[j]]), buckets)
            group_idx = []
            while j < len(order) and len(pieces[order[j]]) <= bucket:
                group_idx.append(order[j])
                j += 1
            # the samples budget bounds POST-resample activation memory, so
            # size batches by the resampled length, not the source length
            budget_len = bucket if resample_arg is None else bucket * up // down
            bs = self.engine_cfg.batch_size_for_bucket(budget_len)
            for s in range(0, len(group_idx), bs):
                jobs.append((bucket, budget_len, group_idx[s : s + bs]))

        # pipelined execution: keep up to pipeline_depth batches in flight so
        # host-side padding and result copies overlap device compute (the
        # host-concurrency role of the reference's ThreadPoolExecutor,
        # yodas2-mimi/process_shard.py:690-717)
        results: List[Optional[np.ndarray]] = [None] * len(pieces)
        inflight: List[tuple] = []  # (handle, idxs)

        def drain_one():
            handle, idxs = inflight.pop(0)
            for g, c in zip(idxs, self._collect(handle)):
                results[g] = c

        for bucket, budget_len, idxs in jobs:
            handle = self._dispatch(
                [pieces[g] for g in idxs], bucket, resample_arg, budget_len
            )
            inflight.append((handle, idxs))
            if len(inflight) >= self.pipeline_depth:
                drain_one()

        def finish() -> List[np.ndarray]:
            while inflight:
                drain_one()
            # reassemble per-utterance codes (concat split pieces on time
            # axis, dropping overlap-context frames when configured)
            out: List[List[np.ndarray]] = [[] for _ in prepared]
            for p_idx, owner in enumerate(piece_of):
                c = results[p_idx]
                drop = piece_drop[p_idx]
                out[owner].append(c[:, drop:] if drop else c)
            return [
                parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
                for parts in out
            ]

        return finish if defer else finish()

    def warmup(self, sr: int = 24_000, include_tails: bool = False) -> int:
        """Run one full-batch encode per bucket of the ``sr`` lattice (the
        fused-resample lattice when sr != engine rate), so the kernels'
        first-use build, cuDNN algorithm selection and the caching
        allocator's pools are set up before the first production shard.
        ``include_tails=True`` additionally runs every tail-ladder batch
        size per bucket. Returns the number of batch shapes warmed."""
        resample_arg, spf_io, domain_sr = self._resample_plan(sr)
        buckets = self._buckets_for(domain_sr, spf_io)
        handles = []
        warmed = 0
        for bucket in buckets:
            budget_len = (
                bucket if resample_arg is None else bucket * resample_arg[0] // resample_arg[1]
            )
            full = self.engine_cfg.batch_size_for_bucket(budget_len)
            # one REPRESENTATIVE group size per reachable batch shape:
            # _dispatch maps n_real through batch_size_for_group
            reps = {full: full}
            if include_tails:
                for n in range(1, full + 1):
                    reps.setdefault(
                        self.engine_cfg.batch_size_for_group(budget_len, n), n
                    )
            for n_rows in reps.values():
                rows = [np.zeros(bucket, dtype=np.int16)] * n_rows
                handles.append(self._dispatch(rows, bucket, resample_arg, budget_len))
                warmed += 1
                if len(handles) >= self.pipeline_depth:
                    self._collect(handles.pop(0))
        for h in handles:
            self._collect(h)
        # warmup work must not pollute throughput metrics
        self.stats = EngineStats()
        return warmed

    def autotune_transfer(self, *args, **kwargs):
        """Provisioning-time A/B probes of transfer format, depth and drain
        policy are not ported yet."""
        raise NotImplementedError("engine autotuning is not ported")

    autotune_pipeline_depth = autotune_drain_policy = request_autotune = autotune_transfer

    def encode_chunk(self, audio: np.ndarray, sr: int = 24_000) -> np.ndarray:
        """Single-utterance encode (reference encode_audio_chunk,
        yodas2-mimi/process_shard.py:197-220)."""
        return self.encode_batch([audio], sr)[0]

    def encode_batch_mixed(self, items: Sequence[tuple]) -> List[np.ndarray]:
        """Encode (audio, sr) pairs with heterogeneous sample rates, results
        in input order — grouped by rate so each engine call resamples
        uniformly (shared by the librispeech and MLS builders)."""
        srs = sorted({sr for _, sr in items})
        results: List[Optional[np.ndarray]] = [None] * len(items)
        for sr in srs:
            idxs = [i for i, (_, s) in enumerate(items) if s == sr]
            codes = self.encode_batch([items[i][0] for i in idxs], sr=sr)
            for i, c in zip(idxs, codes):
                results[i] = c
        return results
