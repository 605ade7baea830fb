"""Length-bucketed Mimi (or EnCodec) batch-encode engine on one GPU.

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
    batch overlaps the device work of the previous ones;
  - on CUDA Mimi's transformer stack of each batch shape is captured as a
    CUDA graph at its first batch and replayed as one launch from its
    second (``graphs.py``), the same ops on the same numbers.

With ``long_audio_policy="stream"``, utterances over the cap are encoded
exactly by the streaming encoder (``mimi/streaming.py``), up to
``stream_batch`` of them multiplexed through one carried state.

Every mode of ``MimiConfig`` runs (bfloat16 compute, TF32 matmuls), both
drain policies of ``EngineConfig`` ("fifo", "ready"), the
provisioning probes (``autotune_transfer``, ``autotune_pipeline_depth``,
``autotune_drain_policy``, and ``request_autotune`` on the first real
batch), and one retry of a transient device fault (``_retry_transient``).

Given an ``encodec.config.EncodecConfig`` in place of a ``MimiConfig``,
the engine runs ``facebook/encodec_24khz``'s encoder instead
(``encodec/model.py``; 320 samples a frame, a 1024-entry codebook, no
transformer: a 2-layer LSTM, one kernel launch a batch), through the same
buckets, batches, transfers and counters, in IEEE float32 and on one
device: its bfloat16 and TF32 modes, the streaming policy and a mesh
raise at construction (``_model_for``).

With a ``parallel.mesh.Mesh`` (one process per GPU under
``torch.distributed``), the batch dimension is split over the mesh's
``data`` axis and params are replicated: every rank passes the same
utterance list, plans the same batches, encodes its data block's rows and
all-gathers the codes, so every rank returns the full result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import math
import time
import weakref
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

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
from tokenize_audio_tpu_torch.encodec import model as encodec_model
from tokenize_audio_tpu_torch.encodec import weights as encodec_weights
from tokenize_audio_tpu_torch.encodec.config import EncodecConfig
from tokenize_audio_tpu_torch.engine.metrics import EngineStats, StreamTimeline
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
from tokenize_audio_tpu_torch.graphs import GraphCache
from tokenize_audio_tpu_torch.mimi.model import _check_modes, cast_for_compute
from tokenize_audio_tpu_torch.mimi.model import encode as mimi_encode
from tokenize_audio_tpu_torch.mimi.streaming import StreamingMimiEncoder
from tokenize_audio_tpu_torch.mimi import weights as mimi_weights
from tokenize_audio_tpu_torch.parallel.mesh import Mesh, batch_sharding
from tokenize_audio_tpu_torch.ranges import span

logger = logging.getLogger(__name__)

# Faults one retry can survive. A CUDA error is often sticky: it poisons the
# context and every later call fails, so an AcceleratorError is retried only
# when the device still runs a probe afterwards (_device_recovers). A failed
# kernel build (ops/cuda/_build) or launch (the kernel wrappers) raises a
# plain RuntimeError, which is never retried: it would fail the same way.
_TRANSIENT = (torch.OutOfMemoryError,) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ()
)


def _mimi(*args, **kwargs):
    # the module's ``mimi_encode`` is looked up at each batch, so a wrapper
    # put on that name sees every launch
    return mimi_encode(*args, **kwargs)


@dataclasses.dataclass(frozen=True)
class _Model:
    """What the engine takes from its model, chosen once from the type of
    its configuration (``_model_for``): the batch encode, with
    ``mimi.model.encode``'s contract; the params it keeps on the device,
    from a checkpoint's tree; and the layers of a recurrence that steps
    through every padded frame (``EngineStats.lstm_steps``); whether the
    encode takes a ``graphs`` cache to replay a stage from (Mimi's
    transformer stack). The frame's length in samples is the
    configuration's ``samples_per_frame``."""

    encode: Callable
    prepare: Callable  # (params, cfg, num_codebooks, device) -> device tree
    lstm_layers: int
    graphs: bool


def _model_for(cfg, engine_cfg: EngineConfig, mesh, device) -> _Model:
    """The model of ``cfg`` (a ``MimiConfig`` or an ``EncodecConfig``) on
    ``device``; an unknown mode, backend or setting raises now, not at the
    first encode."""
    if isinstance(cfg, EncodecConfig):
        encodec_model.check_modes(cfg, device)
        if engine_cfg.long_audio_policy == "stream":
            raise ValueError(
                "EnCodec has no streaming encoder: use long_audio_policy='split'"
            )
        if mesh is not None:
            raise ValueError("EnCodec runs on one device: it takes no mesh")
        return _Model(encodec_model.encode, encodec_weights.prepare, cfg.num_lstm_layers, False)
    _check_modes(cfg)
    return _Model(_mimi, mimi_weights.prepare, 0, True)


def _mesh_device(mesh: Mesh, device) -> torch.device:
    """A mesh engine runs on its rank's device; ``device``, if given, must
    name the same one."""
    if mesh.data_index is None:
        raise ValueError("this rank is not in the mesh's grid (ranks past dp * tp)")
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
            raise ValueError(f"device {want} is not the mesh's device {mesh.device}")
    return mesh.device


class MimiEncoderEngine:
    def __init__(
        self,
        params,
        cfg: Optional[MimiConfig | EncodecConfig] = None,
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
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh must be a tokenize_audio_tpu_torch.parallel.mesh.Mesh, got "
                f"{type(mesh).__name__}"
            )
        self.device = resolve_device(device) if mesh is None else _mesh_device(mesh, device)
        self.pipeline_depth = pipeline_depth
        self.last_autotune: dict = {}  # per-format median probe seconds
        self.last_autotune_depth: dict = {}  # per-depth median probe seconds
        self.last_autotune_drain: dict = {}  # per-policy median probe seconds
        self._pending_autotune: Optional[dict] = None
        self.cfg = cfg or MimiConfig()
        self.engine_cfg = engine_cfg or EngineConfig()
        self._model = _model_for(self.cfg, self.engine_cfg, mesh, self.device)
        self.num_codebooks = num_codebooks or self.engine_cfg.num_codebooks
        self.masked = masked
        self.stats = EngineStats()
        self._batch_ids = itertools.count()  # engine-wide device batch ids
        self._timeline = StreamTimeline(self.device)  # stream_seconds, stream_idle_seconds
        self._bucket_cache: dict = {}
        self._stream_encoders: dict = {}  # stream batch size -> encoder
        self.buckets = self._buckets_for(
            self.engine_cfg.sample_rate, self.cfg.samples_per_frame
        )
        fmt = self.engine_cfg.code_transfer_format
        if fmt not in ("padded", "packed"):
            raise ValueError(f"unknown code_transfer_format {fmt!r}: 'padded' or 'packed'")
        if self.engine_cfg.drain_policy not in ("fifo", "ready"):
            raise ValueError(
                f"unknown drain_policy {self.engine_cfg.drain_policy!r}: 'fifo' or 'ready'"
            )
        if fmt == "packed" and self.num_codebooks % 2 != 0:
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
        self.mesh = mesh
        self._batch_sharding = None
        self._multiprocess = False
        self._batch_multiple = 1
        if mesh is not None:
            dp = mesh.dp
            # every batch must split evenly over the data axis (the row-block
            # upload and the per-row trim both assume uniform row blocks)
            self._batch_multiple = dp
            if self.engine_cfg.batch_size % dp != 0:
                raise ValueError(
                    f"batch_size {self.engine_cfg.batch_size} must divide evenly "
                    f"over the data mesh axis ({dp} devices)"
                )
            self._batch_sharding = batch_sharding(mesh)
            # a grid of more than one process: every rank calls encode_batch
            # with the SAME utterance list (the same plan keeps the
            # collectives in step), uploads only its data block's rows, and
            # the codes all-gather back so every rank returns the full code
            # list. Codes are ~200 B per second of audio, so the gather is
            # negligible next to the audio upload it avoids replicating.
            self._multiprocess = mesh.dp * mesh.tp > 1
        # pruned params live on the device for the engine's lifetime (each
        # rank of a mesh holds a replica): the decoder stack and unused
        # acoustic codebooks are ~half the checkpoint and the encode path
        # never reads them
        params = self._model.prepare(params, self.cfg, self.num_codebooks, self.device)
        # bf16 mode casts the conv/transformer weights once; the streaming
        # encoders always run float32 and take the uncast tree
        self._stream_params = params
        self.params = cast_for_compute(params, self.cfg)
        self._graphs = self._new_graphs()

    # -- internals ---------------------------------------------------------

    def _new_graphs(self) -> Optional[GraphCache]:
        """A cache of CUDA graphs over the engine's params, which stay put
        for its lifetime (Mimi's transformer stack); None off CUDA and for
        a model that replays no stage (EnCodec)."""
        if self.device.type != "cuda" or not self._model.graphs:
            return None
        # weakly: the engine owns the cache, and a strong reference back
        # would keep a dropped engine, its params and its graphs' memory
        # alive until the cycle collector runs
        count = weakref.WeakMethod(self._count_graph)
        return GraphCache(self.device, on_event=lambda kind: count()(kind))

    def _count_graph(self, kind: str) -> None:
        with self.stats._lock:
            if kind == "capture":
                self.stats.transformer_graph_captures += 1
            else:
                self.stats.transformer_graph_replays += 1

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
        handle ``(host_codes, event, n_real, frames, bucket_frames, batch_id)``
        — per-row frame counts are HOST-computed (no device valid fetch),
        ``host_codes``' layout depends on code_transfer_format, and
        ``event`` is the batch's interval's closing mark on the engine's
        ``StreamTimeline`` (None off CUDA).
        ``resample_arg`` = (up, down) for the fused on-device resample (rows
        are at the source rate); ``budget_len`` is the POST-resample length
        used for the activation-memory samples budget (defaults to bucket)."""
        batch_id = next(self._batch_ids)
        with span("engine.dispatch", batch_id):
            group = list(utterances)
            n_real = len(group)
            # tail-ladder batch size >= n_real (bounded set of batch shapes,
            # minimal padded-row waste — see EngineConfig.batch_size_for_group)
            bs = self.engine_cfg.batch_size_for_group(
                budget_len if budget_len is not None else bucket,
                n_real,
                multiple_of=self._batch_multiple,
            )
            # pad rows match the group's dtype so an all-int16 group keeps the
            # narrow-transfer fast path (pad_to_bucket falls back to f32 on mix)
            pad_dtype = group[0].dtype if group else np.float32
            group += [np.zeros(1, dtype=pad_dtype)] * (bs - n_real)
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
                rows = slice(None) if self._batch_sharding is None else self._batch_sharding.span(bs)
                self._timeline.open()
                try:
                    with self.stats.stage("dispatch.upload"):
                        b = torch.from_numpy(batch[rows]).to(self.device)
                        v = torch.from_numpy(lengths[rows]).to(self.device)
                    graphs = {"graphs": self._graphs} if self._model.graphs else {}
                    with self.stats.stage("dispatch.launch"):
                        codes, _ = self._model.encode(
                            self.params,
                            self.cfg,
                            b,
                            v,
                            num_quantizers=self.num_codebooks,
                            masked=self.masked,
                            code_dtype=self.engine_cfg.code_transfer_dtype,
                            resample=resample_arg,
                            transfer=self.engine_cfg.code_transfer_format,
                            **graphs,
                        )
                    # frames per padded row = bucket / samples-per-frame in the
                    # I/O domain (source-rate when the fused resample is active)
                    io_spf = spf if resample_arg is None else spf * down // up
                    row_frames = int(-(-bucket // io_spf))
                    bucket_frames = bs * row_frames
                    with self.stats._lock:
                        self.stats.batches += 1
                        self.stats.lstm_steps += self._model.lstm_layers * row_frames
                    if self._multiprocess:
                        codes = self._gather_rows(codes)
                    # queue the device->host copy now, behind the encode on the same
                    # stream: it starts the moment compute finishes, and _collect
                    # waits on the event instead of synchronizing the device
                    if self.device.type == "cuda":
                        host = torch.empty(codes.shape, dtype=codes.dtype, pin_memory=True)
                        host.copy_(codes, non_blocking=True)
                    else:
                        host = codes
                finally:
                    done = self._timeline.close()
                event = done if self.device.type == "cuda" else None
        return host, event, n_real, frames, bucket_frames, batch_id

    @contextlib.contextmanager
    def _on_stream(self):
        """Put device work the engine queues outside ``_dispatch`` and
        waits for (a resample, a streaming group) on its timeline as an
        interval, as a batch is, so the stream's idle stays true idle."""
        self._timeline.open()
        try:
            yield
        finally:
            self._timeline.close()
            self._timeline.read(self.stats)

    def _gather_rows(self, codes: torch.Tensor) -> torch.Tensor:
        """The whole batch's codes from every data block's rows: an
        all-gather over the mesh's data group, on the stream behind the
        encode, so the device-to-host copy queued after it reads the
        gathered codes. The codes go as raw bytes (uint8), which both NCCL
        and gloo carry whatever the code dtype. Under gloo a CUDA tensor is
        staged through host memory by gloo itself."""
        raw = codes.contiguous().view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(self.mesh.dp)]
        dist.all_gather(parts, raw, group=self.mesh.data_group)
        return torch.cat(parts).view(codes.dtype)

    def _device_recovers(self, exc: BaseException) -> bool:
        """Whether the device can take a retry after ``exc``: always after
        an out-of-memory error (once the allocator's cached blocks are
        released); after another CUDA error only if a synchronize and a
        tiny op still run, which a sticky error fails."""
        if isinstance(exc, torch.OutOfMemoryError):
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            return True
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            torch.ones(1, device=self.device).add_(1).cpu()
        except RuntimeError:
            return False
        return True

    def _retry_transient(self, what: str, attempt, recover=None):
        """Run ``attempt()``, absorbing ONE transient device fault
        (``_TRANSIENT``, where the device recovers).

        Encode is stateless at every retry grain — params stay on the
        device, inputs are host-owned numpy — so one retry (``recover()``,
        defaulting to ``attempt()`` again) is exact and turns a would-be
        shard-attempt abort into a counted ``transient_retries`` stat. A
        persistent fault re-raises into the shard-level restart-resume
        machinery. A multiprocess mesh never retries: a lone re-dispatch
        would put this rank's collectives out of step with its peers'."""
        try:
            return attempt()
        except _TRANSIENT as e:
            # the fault may have struck inside a capture or replay: start
            # the graphs afresh, before an out-of-memory recovery releases
            # the allocator's cache, so their pool goes with it
            self._graphs = self._new_graphs()
            if self._multiprocess or not self._device_recovers(e):
                raise
            logger.warning("transient device fault %s; retrying once: %s", what, e)
            with self.stats._lock:
                self.stats.transient_retries += 1
            return (recover or attempt)()

    def _collect(self, handle) -> List[np.ndarray]:
        """Wait for an in-flight batch and trim per-row codes."""
        host, event, n_real, frames, bucket_frames, batch_id = handle
        with span("engine.collect", batch_id):
            with self.stats.stage("fetch"):
                with self.stats.stage("fetch.wait"):
                    if event is not None:
                        event.synchronize()
                codes = host.numpy()
            out, n_frames = self._trim(codes, n_real, frames)
        self._timeline.read(self.stats)
        with self.stats._lock:
            self.stats.frames += n_frames
            self.stats.padded_frames += bucket_frames
        return out

    def _trim(self, codes: np.ndarray, n_real: int, frames) -> "tuple[List[np.ndarray], int]":
        """Each real row's (K, frames) codes from a batch's host buffer in
        the transfer format, and the frames they hold."""
        dtype = np.dtype(self.engine_cfg.code_transfer_dtype)
        out = []
        n_frames = 0
        if self.engine_cfg.code_transfer_format == "padded":
            for i in range(n_real):
                f = int(frames[i])
                # copy: a trimmed VIEW would pin the whole (B, K, T_bucket)
                # batch buffer for as long as a caller keeps one row's codes
                out.append(codes[i, :, :f].copy())
                n_frames += f
        else:
            # int32 words -> exact uint16 code stream via a zero-copy
            # little-endian view (pairs pack low|high<<16)
            u16 = np.ascontiguousarray(codes).view("<u2")
            u16 = u16.reshape(codes.shape[0], codes.shape[1], -1)  # (B, T, K)
            for i in range(n_real):
                f = int(frames[i])
                out.append(u16[i, :f].T.astype(dtype))
                n_frames += f
        return out, n_frames

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
            with self.stats.stage("resample"), self._on_stream():
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
        if self._pending_autotune is not None:
            # deferred real-workload autotune (request_autotune): probe on
            # THIS call's utterances, then fall through and encode them
            # with the chosen config. Cleared first — the probe re-enters
            # encode_batch.
            pa, self._pending_autotune = self._pending_autotune, None
            if pa["transfer"]:
                self.autotune_transfer(
                    seconds=pa["seconds"], rounds=pa["rounds"], samples=audios, sr=sr
                )
            if pa["depth"]:
                self.autotune_pipeline_depth(
                    depths=pa["depths"], seconds=pa["seconds"],
                    rounds=pa["rounds"], samples=audios, sr=sr,
                )
            if pa["on_complete"] is not None:
                pa["on_complete"]()
        self.stats.start_clock()
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
            with self.stats.stage("resample"), self._on_stream():
                prepared = resample_many(raw, sr, rate, device=self.device)
        else:
            prepared = [self._prepare(a, sr) for a in audios]
        buckets = self._buckets_for(domain_sr, spf_io)
        # explode >cap audio into pieces, remembering the mapping
        pieces: List[np.ndarray] = []
        piece_of: List[int] = []
        piece_drop: List[int] = []  # leading context frames to discard
        stream_jobs: List[tuple] = []  # (utterance index, 24 kHz float audio)
        cap = int(self.engine_cfg.max_chunk_seconds * domain_sr)
        ctx = int(self.engine_cfg.split_context_seconds * domain_sr)
        for i, a in enumerate(prepared):
            self.stats.audio_seconds += len(a) / domain_sr
            self.stats.utterances += 1
            if self.engine_cfg.long_audio_policy == "stream" and len(a) > cap:
                if domain_sr != rate:
                    # the streaming encoder consumes 24 kHz audio: resample
                    # this utterance as the unfused path does
                    with self.stats.stage("resample"), self._on_stream():
                        a = resample(pcm_to_float(a), domain_sr, rate, device=self.device)
                        a = a.cpu().numpy()
                # the streaming encoder consumes float audio (push() casts
                # without PCM scaling); normalize raw-int16 fast-path input
                stream_jobs.append((i, pcm_to_float(a)))
                continue
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
            bs = self.engine_cfg.batch_size_for_bucket(
                budget_len, multiple_of=self._batch_multiple
            )
            for s in range(0, len(group_idx), bs):
                jobs.append((bucket, budget_len, group_idx[s : s + bs]))

        # pipelined execution: keep up to pipeline_depth batches in flight so
        # host-side padding and result copies overlap device compute (the
        # host-concurrency role of the reference's ThreadPoolExecutor,
        # yodas2-mimi/process_shard.py:690-717)
        results: List[Optional[np.ndarray]] = [None] * len(pieces)
        inflight: List[tuple] = []  # (handle, idxs, bucket, budget_len)
        # a multiprocess mesh keeps FIFO: collection must not interleave
        # with the collective schedule every rank follows
        policy = "fifo" if self._multiprocess else self.engine_cfg.drain_policy

        def drain_one():
            pick = 0
            if policy == "ready":
                # the first batch whose codes have reached the host, so
                # this collect never waits behind a slower, older one;
                # FIFO when none has (or on the CPU, with no events).
                # Results scatter by piece index, so the order of
                # collection never changes the output's order or bits.
                pick = next(
                    (j for j, (h, *_) in enumerate(inflight)
                     if h[1] is not None and h[1].query()),
                    0,
                )
            handle, idxs, bucket, budget_len = inflight.pop(pick)
            # a fault at collect time recovers by re-dispatching the whole
            # group and collecting that
            collected = self._retry_transient(
                f"collecting a {len(idxs)}-row batch",
                lambda: self._collect(handle),
                recover=lambda: self._collect(
                    self._dispatch([pieces[g] for g in idxs], bucket, resample_arg, budget_len)
                ),
            )
            for g, c in zip(idxs, collected):
                results[g] = c

        for bucket, budget_len, idxs in jobs:
            handle = self._retry_transient(
                f"dispatching a {len(idxs)}-row batch",
                lambda: self._dispatch(
                    [pieces[g] for g in idxs], bucket, resample_arg, budget_len
                ),
            )
            inflight.append((handle, idxs, bucket, budget_len))
            if len(inflight) >= self.pipeline_depth:
                drain_one()

        def finish() -> List[np.ndarray]:
            while inflight:
                drain_one()

            # long-audio streaming, MULTIPLEXED: up to stream_batch >cap
            # utterances share one carried-state encoder (per-row ends — a
            # YODAS2 shard of K full videos streams in ~1/K the steps),
            # identical to the serial path
            streamed: dict = {}
            for s in range(0, len(stream_jobs), self.engine_cfg.stream_batch):
                grp = stream_jobs[s : s + self.engine_cfg.stream_batch]
                enc = self._stream_encoder_for(len(grp))
                with self.stats.stage("stream"), self._on_stream():
                    # retry is exact: encode_streams resets carried state at
                    # entry, so the whole group re-streams from scratch
                    codes_list = self._retry_transient(
                        f"streaming a {len(grp)}-stream group",
                        lambda: enc.encode_streams([a for _, a in grp]),
                    )
                for (i, _), c in zip(grp, codes_list):
                    with self.stats._lock:
                        self.stats.frames += c.shape[1]
                        # streamed frames carry no bucket padding; count
                        # them on both sides so bucket_efficiency keeps
                        # measuring bucketed waste only
                        self.stats.padded_frames += c.shape[1]
                    # match the bucketed path's configured transfer dtype
                    streamed[i] = c.astype(np.dtype(self.engine_cfg.code_transfer_dtype))

            # reassemble per-utterance codes (concat split pieces on time
            # axis, dropping overlap-context frames when configured)
            out: List[List[np.ndarray]] = [[] for _ in prepared]
            for p_idx, owner in enumerate(piece_of):
                c = results[p_idx]
                drop = piece_drop[p_idx]
                out[owner].append(c[:, drop:] if drop else c)
            return [
                streamed[i]
                if i in streamed
                else (parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1))
                for i, parts in enumerate(out)
            ]

        return finish if defer else finish()

    def _stream_encoder_for(self, n_streams: int) -> StreamingMimiEncoder:
        """Carried-state streaming encoder sized to the next power of two
        >= n_streams, cached per size (unused rows ride along as
        zero-length streams), on the engine's device copy of the pruned,
        packed float32 params (the stream ignores compute_dtype). Exact
        long-audio encode: codes identical to a
        one-shot encode of the whole stream (no 60 s receptive-field cuts).
        Full-causal configs cut streams beyond stream_max_seconds (the HF
        one-shot horizon) at that whole-chunk boundary inside
        encode_streams, each piece streamed exactly; windowed configs never
        cut."""
        cap = self.engine_cfg.stream_batch
        b = 1
        while b < min(n_streams, cap):
            b *= 2
        # cap is a bound, not a rounding target: a non-power-of-two
        # stream_batch must not balloon into the next power (full-causal
        # KV is ~262 MB per row)
        b = min(b, cap)
        if b not in self._stream_encoders:
            self._stream_encoders[b] = StreamingMimiEncoder(
                self._stream_params,
                self.cfg,
                batch=b,
                chunk_seconds=min(8.0, self.engine_cfg.stream_max_seconds),
                max_seconds=self.engine_cfg.stream_max_seconds,
                num_quantizers=self.num_codebooks,
                device=self.device,
            )
        return self._stream_encoders[b]

    def warmup(self, sr: int = 24_000, include_tails: bool = False) -> int:
        """Run one full-batch encode per bucket of the ``sr`` lattice (the
        fused-resample lattice when sr != engine rate), so the kernels'
        first-use build, cuDNN algorithm selection and the caching
        allocator's pools are set up before the first production shard.
        ``include_tails=True`` additionally runs every tail-ladder batch
        size per bucket. Returns the number of batch shapes warmed."""
        resample_arg, spf_io, domain_sr = self._resample_plan(sr)
        buckets = self._buckets_for(domain_sr, spf_io)
        mult = self._batch_multiple
        handles = []
        warmed = 0
        for bucket in buckets:
            budget_len = (
                bucket if resample_arg is None else bucket * resample_arg[0] // resample_arg[1]
            )
            full = self.engine_cfg.batch_size_for_bucket(budget_len, multiple_of=mult)
            # one REPRESENTATIVE group size per reachable batch shape:
            # _dispatch maps n_real through batch_size_for_group
            reps = {full: full}
            if include_tails:
                for n in range(1, full + 1):
                    reps.setdefault(
                        self.engine_cfg.batch_size_for_group(budget_len, n, multiple_of=mult), n
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

    def _probe_workload(
        self,
        seconds: float,
        seed: int,
        samples: Optional[Sequence[np.ndarray]] = None,
        sr: Optional[int] = None,
    ) -> "tuple[List[np.ndarray], int]":
        """Workload for the autotune probes: caller-supplied real
        utterances when given (capped to ~``seconds`` of audio so probe
        cost stays bounded), else a seeded lognormal int16 synthetic.
        Probing the real shard's length mix matters: the synthetic caps at
        25 s while production runs to the 60 s cap, and a format picked on
        a workload it never saw can mis-rank."""
        sr = sr or self.engine_cfg.sample_rate
        if samples is not None:
            utts: List[np.ndarray] = []
            total = 0.0
            for a in samples:
                arr = np.asarray(a)
                utts.append(arr)
                # duration = the time axis, which for 2-D audio is the
                # LARGE axis (channels live on the small one, <= 8 —
                # _prepare_mono's contract); len() would count channels
                # for channels-first input and break the seconds cap
                n = max(arr.shape) if arr.ndim == 2 else arr.size
                total += n / sr
                if total >= seconds:
                    break
            if not utts:
                raise ValueError("autotune samples must be non-empty")
            return utts, sr
        rng = np.random.default_rng(seed)
        utts = []
        total = 0.0
        max_dur = min(25.0, self.engine_cfg.max_chunk_seconds)
        while total < seconds:
            dur = float(np.clip(rng.lognormal(1.7, 0.9), 0.5, max_dur))
            utts.append(rng.integers(-4000, 4000, int(dur * sr), dtype=np.int16))
            total += dur
        return utts, sr

    def _interleaved_ab(self, candidates, set_candidate, utts, sr: int, rounds: int) -> dict:
        """Time ``rounds`` interleaved encode passes per candidate (one
        unmeasured warm pass each first, so first-use set-up never
        contaminates timings) and return {candidate: median seconds}.
        Interleaving keeps drift of the machine out of the comparison."""
        timings: dict = {c: [] for c in candidates}
        for c in candidates:  # unmeasured warm pass
            set_candidate(c)
            self.encode_batch(utts, sr=sr)
        for _ in range(max(1, rounds)):
            for c in candidates:
                set_candidate(c)
                t0 = time.perf_counter()
                self.encode_batch(utts, sr=sr)
                timings[c].append(time.perf_counter() - t0)
        return {c: float(np.median(ts)) for c, ts in timings.items()}

    def _probe(self, candidates, set_candidate, utts, sr: int, rounds: int) -> dict:
        """``_interleaved_ab`` on fresh stats. The engine's config, depth
        and stats are restored on every exit, KeyboardInterrupt included,
        so an interrupted probe never leaves the engine in a candidate's
        config; the caller then applies the winner."""
        saved = self.stats, self.engine_cfg, self.pipeline_depth
        self.stats = EngineStats()
        try:
            return self._interleaved_ab(candidates, set_candidate, utts, sr, rounds)
        finally:
            self.stats, self.engine_cfg, self.pipeline_depth = saved

    def autotune_transfer(
        self,
        seconds: float = 40.0,
        rounds: int = 3,
        seed: int = 0,
        samples: Optional[Sequence[np.ndarray]] = None,
        sr: Optional[int] = None,
    ) -> str:
        """Pick the fastest ``code_transfer_format`` on THIS machine by a
        within-process interleaved A/B, then switch the engine to it
        (CLI ``--code-transfer-format auto``, right after ``warmup``).

        Pass ``samples`` (+ their ``sr``) to probe on real shard
        utterances instead of the synthetic lognormal (capped to
        ``seconds`` of audio); ``request_autotune`` wires this to the first
        production batch. Encode is stateless, so switching formats only
        changes the wire layout; codes are bit-equal across formats.
        Engine throughput stats are untouched. Returns the chosen format;
        per-format median seconds land in ``self.last_autotune``."""
        if self._multiprocess:
            raise RuntimeError(
                "autotune_transfer times per-process; SPMD multiprocess "
                "engines must set code_transfer_format explicitly (every "
                "process must dispatch the same programs)"
            )
        candidates = ["packed", "padded"] if self.num_codebooks % 2 == 0 else ["padded"]
        if len(candidates) == 1:
            # the constructor's odd-K fallback already pinned this format:
            # a timed probe to "choose" the only option would burn encode
            # passes for nothing
            self.last_autotune = {candidates[0]: 0.0}
            self._set_transfer_format(candidates[0])
            return candidates[0]
        utts, sr = self._probe_workload(seconds, seed, samples, sr)
        medians = self._probe(candidates, self._set_transfer_format, utts, sr, rounds)
        self.last_autotune = medians
        best = min(candidates, key=lambda f: medians[f])
        self._set_transfer_format(best)
        logger.info(
            "autotune_transfer picked %r (medians: %s)",
            best, {f: f"{m:.3f}s" for f, m in medians.items()},
        )
        return best

    def autotune_pipeline_depth(
        self,
        depths: Sequence[int] = (6, 12, 18),
        seconds: float = 40.0,
        rounds: int = 3,
        seed: int = 0,
        samples: Optional[Sequence[np.ndarray]] = None,
        sr: Optional[int] = None,
    ) -> int:
        """Pick the fastest ``pipeline_depth`` (in-flight device batches)
        by the same interleaved A/B as :meth:`autotune_transfer`, then
        switch the engine to it. Depth is transport-only: more hides more
        per-batch host latency at the cost of pinned and device buffers.
        Returns the chosen depth; per-depth median seconds land in
        ``self.last_autotune_depth``."""
        if self._multiprocess:
            raise RuntimeError(
                "autotune_pipeline_depth times per-process; SPMD "
                "multiprocess engines must set pipeline_depth explicitly"
            )
        depths = [int(d) for d in depths]
        if any(d < 1 for d in depths):
            raise ValueError(f"pipeline depths must be >= 1: {depths}")
        utts, sr = self._probe_workload(seconds, seed, samples, sr)

        def set_depth(d: int) -> None:
            self.pipeline_depth = d

        medians = self._probe(depths, set_depth, utts, sr, rounds)
        self.last_autotune_depth = medians
        best = min(depths, key=lambda d: medians[d])
        set_depth(best)
        logger.info(
            "autotune_pipeline_depth picked %d (medians: %s)",
            best, {d: f"{m:.3f}s" for d, m in medians.items()},
        )
        return best

    def autotune_drain_policy(
        self,
        policies: Sequence[str] = ("fifo", "ready"),
        seconds: float = 40.0,
        rounds: int = 3,
        seed: int = 0,
        samples: Optional[Sequence[np.ndarray]] = None,
        sr: Optional[int] = None,
    ) -> str:
        """Pick the fastest ``drain_policy`` by the same interleaved A/B as
        :meth:`autotune_transfer`, then switch to it (CLI
        ``--drain-policy auto``). Bits and result order are identical in
        every policy, so the probe is pure transport scheduling. Returns
        the chosen policy; per-policy median seconds land in
        ``self.last_autotune_drain``."""
        if self._multiprocess:
            raise RuntimeError(
                "autotune_drain_policy: SPMD multiprocess engines always "
                "drain FIFO (collection must not interleave with the "
                "collective dispatch schedule)"
            )
        policies = [str(p) for p in policies]
        allowed = {"fifo", "ready"}
        if not set(policies) <= allowed:
            raise ValueError(f"unknown drain policies: {set(policies) - allowed}")
        utts, sr = self._probe_workload(seconds, seed, samples, sr)

        def set_policy(p: str) -> None:
            self.engine_cfg = dataclasses.replace(self.engine_cfg, drain_policy=p)

        medians = self._probe(policies, set_policy, utts, sr, rounds)
        self.last_autotune_drain = medians
        best = min(policies, key=lambda p: medians[p])
        set_policy(best)
        logger.info(
            "autotune_drain_policy picked %r (medians: %s)",
            best, {p: f"{m:.3f}s" for p, m in medians.items()},
        )
        return best

    def request_autotune(
        self,
        transfer: bool = True,
        depth: bool = False,
        seconds: float = 40.0,
        rounds: int = 3,
        depths: Sequence[int] = (6, 12, 18),
        on_complete: Optional[Callable[[], None]] = None,
    ) -> None:
        """Defer autotuning to the first :meth:`encode_batch` call, which
        probes on THAT call's utterances — the real workload's length mix
        and dtype — instead of the synthetic lognormal. The first batch is
        encoded with the chosen config right after the probe; later
        batches are untouched. ``on_complete`` (if given) runs after the
        probes pick, before the triggering batch is encoded — the CLI uses
        it to re-warm the bucket lattices when the probe switches wire
        formats. CLI: ``--code-transfer-format auto-data`` /
        ``--pipeline-depth auto-data``."""
        if self._multiprocess:
            raise RuntimeError(
                "request_autotune: SPMD multiprocess engines must be "
                "configured explicitly"
            )
        self._pending_autotune = {
            "transfer": transfer,
            "depth": depth,
            "seconds": seconds,
            "rounds": rounds,
            "depths": tuple(depths),
            "on_complete": on_complete,
        }

    def _set_transfer_format(self, fmt: str) -> None:
        self.engine_cfg = dataclasses.replace(self.engine_cfg, code_transfer_format=fmt)

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
