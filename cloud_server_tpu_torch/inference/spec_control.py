"""Adaptive speculative-decoding control: per-slot draft-length tuning
from observed accept rates. A copy of the reference's
`inference/spec_control.py` (stdlib only).

Speculation pays only when drafts are accepted: every rejected draft
token is a verify-window position the target model scored for nothing,
and `spec_drafts` as a static construction-time knob forces one length
on every request — the repetition-heavy request that accepts 3-of-3
and the random-prompt request that accepts 0-of-3 ride the same
window. This module closes the loop host-side: the scheduler already
syncs per-round committed counts (`n_acc + 1` per slot), so a rolling
accept rate per slot costs nothing extra, and the per-iteration draft
count becomes a CONTROLLED resource — each slot carries its own draft
length in [0, spec_drafts], each row commits at most its own
(`draft_limit` in `_spec_core`, the same exact truncation the
`stop_len` cap already performs), and the dispatch width stays
quantized to {0, spec_drafts} — `n_drafts` is a static shape, so
intermediate widths would cost a compile each for a sliver of verify
compute; the all-off dispatch is plain decode with no draft passes.

Control law (all knobs in `SpecControlConfig`):

  * per-slot EWMA of accepted/drafted per committed round;
  * HYSTERESIS with a cooldown: the length steps +1 when the rate
    crosses `high`, -1 when it falls under `low`, and never moves
    again for `cooldown` observed rounds — so the draft-model cache
    discipline (which is exact at ANY per-round length, see
    `_spec_core`) is not churned by single-round noise;
  * length 0 is plain decode for that slot ("off"). An n-gram slot —
    and a draft-model slot whose draft cache stayed warm (it rode at
    length 0 inside other slots' speculative windows, where the draft
    model still processes its `last` token every round) — PROBES back
    to length 1 after `probe_period` idle rounds. A draft-model slot
    that sat through plain-decode dispatches (no draft rows ran at
    all) has a STALE draft cache — positions decoded plainly were
    never draft-prefilled — so it stays off for the rest of the
    request (`on_plain_dispatch` marks it; re-admission after a
    preemption re-prefills the draft cache and clears the mark).

Exactness is never the controller's job: the accept rule commits an
exact sample at every length, including 0 (the round's single
committed token is the draft if accepted else the corrective — the
marginal is the target distribution either way), so the controller
tunes THROUGHPUT only. Greedy outputs are token-for-token identical
at any length schedule (tests/test_torch_mixed_scheduler.py pins
this through mid-stream length changes).

Everything here is plain host arithmetic on Python ints/floats — the
controller runs inside the scheduler iteration: no numpy buffers,
no device work, no clocks, no I/O. Single-writer discipline: only the
scheduler thread mutates state; scrape-path readers (`accept_rate`,
`draft_lengths`) take list() copies and tolerate torn-but-plausible
values, like the flight recorder.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class SpecControlConfig:
    """Adaptive-speculation knobs (JSON object / string / file path via
    `InferConfig.spec_control_config`, server `spec_control=`, CLI
    `--spec-control`; the literal "off" disables adaptation — fixed
    `spec_drafts` length, the pre-adaptive behavior).

    `low`/`high` are the hysteresis thresholds on the per-slot EWMA of
    accepted-per-drafted; `ewma` is the smoothing factor (higher =
    faster reaction, noisier); `cooldown` is the minimum observed
    rounds between length changes for one slot; `probe_period` is how
    many length-0 rounds a slot waits before probing back to length 1
    (never, for a draft-model slot with a stale draft cache);
    `initial` is the admission draft length (None = spec_drafts —
    optimistic start, so high-acceptance workloads never pay a ramp)."""

    low: float = 0.30
    high: float = 0.60
    ewma: float = 0.25
    cooldown: int = 4
    probe_period: int = 64
    initial: int | None = None

    def __post_init__(self) -> None:
        if not 0.0 <= self.low < self.high <= 1.0:
            raise ValueError(
                f"need 0 <= low < high <= 1 (got low={self.low}, "
                f"high={self.high}); equal thresholds would oscillate "
                "every round")
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError("ewma must be in (0, 1]")
        if self.cooldown < 1:
            raise ValueError("cooldown must be >= 1 round")
        if self.probe_period < 1:
            raise ValueError("probe_period must be >= 1 round")
        if self.initial is not None and self.initial < 0:
            raise ValueError("initial draft length must be >= 0")


class _SlotState:
    """Per-slot controller state (controller-private)."""

    __slots__ = ("length", "rate", "since_change", "zero_rounds",
                 "stale")

    def __init__(self, length: int, rate: float):
        self.length = length
        self.rate = rate
        self.since_change = 0
        self.zero_rounds = 0
        self.stale = False


class SpecController:
    """Host-side adaptive draft-length controller for one server.

    The scheduler drives it at moments it already owns:
      * `on_admit(slot)` when a slot is (re-)admitted — fresh state at
        the initial length (re-admission re-prefills the draft cache,
        so staleness clears);
      * `draft_len(slot)` when planning a dispatch (any live slot
        drafting keeps the spec program; each row's cap is its own);
      * `observe(slot, drafted, accepted)` once per committed decode
        round, from the counts the scheduler synced anyway;
      * `on_plain_dispatch(slots, rounds)` when a decode dispatch ran
        with no draft rows at all (every live length 0): draft-model
        slots go stale (their caches miss the plainly-decoded
        positions), n-gram slots accrue probe credit;
      * `on_release(slot)` at slot teardown.
    """

    def __init__(self, max_drafts: int,
                 config: SpecControlConfig | None = None, *,
                 has_draft_model: bool = False):
        if max_drafts <= 0:
            raise ValueError("adaptive speculation needs spec_drafts > 0")
        self.max_drafts = int(max_drafts)
        self.config = config if config is not None else SpecControlConfig()
        self.has_draft_model = bool(has_draft_model)
        self._initial = (self.max_drafts if self.config.initial is None
                         else min(self.config.initial, self.max_drafts))
        # neutral EWMA seed: new slots start between the thresholds so
        # neither direction fires until real rounds move the estimate
        self._neutral = 0.5 * (self.config.low + self.config.high)
        self._slots: dict[int, _SlotState] = {}
        # global rolling accept rate (the scrape-path gauge); rounds
        # with drafted == 0 carry no acceptance information and are
        # excluded, so "everything off" freezes rather than zeroes it
        self._rate = self._neutral
        self._observed_rounds = 0
        self.length_changes = 0  # lifetime, for tests/flight debugging

    # -- slot lifecycle ------------------------------------------------------

    def on_admit(self, slot_id: int) -> None:
        self._slots[slot_id] = _SlotState(self._initial, self._neutral)

    def on_release(self, slot_id: int) -> None:
        self._slots.pop(slot_id, None)

    # -- dispatch planning (hot path) ----------------------------------------

    def draft_len(self, slot_id: int) -> int:
        st = self._slots.get(slot_id)
        return self._initial if st is None else st.length

    # -- feedback (hot path) -------------------------------------------------

    def observe(self, slot_id: int, drafted: int, accepted: int) -> None:
        """One committed decode round for `slot_id`: `drafted` tokens
        were proposed on the row's behalf (its own length, not the
        dispatch width), `accepted` of them committed. drafted == 0
        rounds (the slot rode a speculative window at length 0) only
        accrue probe credit."""
        st = self._slots.get(slot_id)
        if st is None:
            return
        cfg = self.config
        if drafted <= 0:
            st.zero_rounds += 1
            if (st.length == 0 and not st.stale
                    and st.zero_rounds >= cfg.probe_period):
                st.length = 1
                st.rate = self._neutral  # a fair shot, not stale history
                st.since_change = 0
                st.zero_rounds = 0
                self.length_changes += 1
            return
        r = min(accepted, drafted) / drafted
        st.rate += cfg.ewma * (r - st.rate)
        self._rate += cfg.ewma * (r - self._rate)
        self._observed_rounds += 1
        st.since_change += 1
        if st.since_change < cfg.cooldown:
            return
        if st.rate >= cfg.high and st.length < self.max_drafts:
            st.length += 1
            st.since_change = 0
            self.length_changes += 1
        elif st.rate <= cfg.low and st.length > 0:
            st.length -= 1
            st.since_change = 0
            st.zero_rounds = 0
            self.length_changes += 1

    def on_plain_dispatch(self, slot_ids, rounds: int) -> None:
        """A decode dispatch ran with zero draft rows (every live slot
        at length 0). Draft-model slots' caches now miss the plainly
        decoded positions — sticky off; n-gram slots (cache-free) just
        accrue `rounds` of probe credit."""
        for sid in slot_ids:
            st = self._slots.get(sid)
            if st is None:
                continue
            if self.has_draft_model:
                st.stale = True
                continue
            for _ in range(rounds):
                self.observe(sid, 0, 0)

    # -- scrape-path views ---------------------------------------------------

    def accept_rate(self) -> float:
        """Rolling (EWMA) fleet accept rate over committed rounds —
        the `cloud_server_spec_accept_rate` gauge source."""
        return self._rate if self._observed_rounds else 0.0

    def draft_lengths(self) -> dict[int, int]:
        """{slot_id: current draft length} for live slots (flight
        recorder / /stats view; copied, safe off-thread)."""
        return {sid: st.length for sid, st in list(self._slots.items())}


def resolve_controller(spec, config_str: str, max_drafts: int, *,
                       has_draft_model: bool) -> SpecController | None:
    """The one constructor the paged server uses. `spec` may be a ready
    SpecController, a SpecControlConfig, a config dict / JSON string /
    file path, None (falling back to `InferConfig.spec_control_config`),
    or the literal False — adaptation force-disabled (fixed
    `spec_drafts` draft length, the bench's fixed-length arms). The
    fallback string "" selects the DEFAULT adaptive config (adaptive
    speculation is on whenever speculation is); the literal "off"
    disables it. Returns None when adaptation is off or speculation is
    not configured at all."""
    if max_drafts <= 0 or spec is False:
        return None
    if isinstance(spec, SpecController):
        if spec.max_drafts != max_drafts:
            # fail at construction: a controller planning lengths above
            # the dispatch width would overbill the drafted-token
            # ledgers and depress every accept rate by the same factor
            # (a perfectly-accepting slot could never climb)
            raise ValueError(
                f"spec_control.max_drafts={spec.max_drafts} does not "
                f"match the server's spec_drafts={max_drafts}")
        return spec
    cfg = spec if spec is not None else (config_str or "")
    if isinstance(cfg, str):
        text = cfg.strip()
        if text.lower() == "off":
            return None
        if text == "":
            cfg = SpecControlConfig()
        else:
            if not text.startswith("{"):
                with open(text) as f:  # a path, not inline JSON
                    text = f.read()
            cfg = json.loads(text)
    if isinstance(cfg, dict):
        unknown = set(cfg) - {f.name for f in
                              dataclasses.fields(SpecControlConfig)}
        if unknown:
            raise ValueError(
                f"unknown spec_control keys: {sorted(unknown)}")
        cfg = SpecControlConfig(**cfg)
    if not isinstance(cfg, SpecControlConfig):
        raise ValueError(
            "spec_control must be a SpecControlConfig, a JSON object, "
            "a file path, False, or 'off'")
    return SpecController(max_drafts, cfg,
                          has_draft_model=has_draft_model)
