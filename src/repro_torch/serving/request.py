"""Request model shared by the real engine and the EPD simulator."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

_ids = itertools.count()


@dataclass
class Request:
    prompt_tokens: List[int]
    max_new_tokens: int = 64
    # multimodal payload: raw bytes standing in for an image/audio clip;
    # None => text-only request (takes the P-D path, paper §3.4)
    mm_payload: Optional[bytes] = None
    mm_tokens: int = 0                  # vision/audio token count
    # position of the image run within the combined sequence: the first
    # mm_pos entries of prompt_tokens precede the image tokens, the rest
    # follow (0 = image-first, the legacy prepend ordering)
    mm_pos: int = 0
    eos_token: int = -1                 # -1: never stop early
    # preemption: higher priority is preempted later; killed marks a
    # request dropped by the no-preemption OOM baseline; n_preempts
    # counts page-level preemptions (starvation-guard + metrics)
    priority: int = 0
    killed: bool = False
    n_preempts: int = 0
    request_id: int = field(default_factory=lambda: next(_ids))

    # lifecycle timestamps (simulation or wall-clock), seconds
    t_arrival: float = 0.0
    t_encode_start: float = -1.0
    t_encode_done: float = -1.0
    t_prefill_start: float = -1.0
    t_first_token: float = -1.0
    t_done: float = -1.0

    output_tokens: List[int] = field(default_factory=list)

    @property
    def is_multimodal(self) -> bool:
        return self.mm_payload is not None

    @property
    def total_prompt_len(self) -> int:
        return len(self.prompt_tokens) + self.mm_tokens

    # -- metrics ------------------------------------------------------------
    def stage_breakdown(self) -> dict:
        """Where the TTFT went: queueing/encode/dispatch/prefill (seconds).

        encode_queue covers arrival -> encode start (or prefill start for
        text-only); dispatch covers the E->P hand-off (store fetch +
        scheduling) for multimodal requests.
        """
        out = {}
        if self.is_multimodal and self.t_encode_start >= 0:
            out["encode_queue"] = self.t_encode_start - self.t_arrival
            out["encode"] = self.t_encode_done - self.t_encode_start
            out["dispatch"] = max(0.0, self.t_prefill_start
                                  - self.t_encode_done)
        else:
            out["encode_queue"] = 0.0
            out["encode"] = 0.0
            out["dispatch"] = max(0.0, self.t_prefill_start - self.t_arrival)
        out["prefill"] = self.t_first_token - self.t_prefill_start
        out["decode"] = max(0.0, self.t_done - self.t_first_token)
        return out

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrival

    @property
    def tpot(self) -> float:
        n = len(self.output_tokens)
        if n <= 1 or self.t_done < 0:
            return 0.0
        return (self.t_done - self.t_first_token) / (n - 1)

    def meets_slo(self, ttft_ms: float, tpot_ms: float) -> bool:
        return (self.ttft * 1e3 <= ttft_ms) and (self.tpot * 1e3 <= tpot_ms)
