"""CrushTester: batch placement verification with distribution stats.

Behavioral analog of the reference's crushtool --test machinery
(CrushTester::test, src/crush/CrushTester.cc:472; crushtool.cc:1024):
map a range of x values through a rule and report per-device placement
counts, utilization vs weight expectation, bad (short) mappings, and
first-choice distribution — the tool operators use to validate a map
before deploying it.

A copy of ``ceph_tpu/crush/tester.py`` on the port's mapper.  When the
map is straw2-only with optimal tunables the whole batch runs through the
batched TensorMapper on the tester's device (CUDA unless the caller names
the CPU); map shapes the batched mapper rejects (legacy tunables,
non-straw2 buckets, sparse bucket ids, local-retry rule steps) take the
scalar oracle, as the reference does: that is their semantics, not a
device fallback, and it is logged and counted in ``KERNELS``
``crush_scalar_fallbacks``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import logging

import numpy as np

from ceph_tpu_torch.crush.mapper import TensorMapper
from ceph_tpu_torch.crush.scalar import ScalarMapper
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, CrushMap
from ceph_tpu_torch.utils.perf import KERNELS


@dataclass
class TestReport:
    n_inputs: int
    result_max: int
    total_placements: int
    bad_mappings: List[int] = field(default_factory=list)
    device_counts: Dict[int, int] = field(default_factory=dict)
    first_counts: Dict[int, int] = field(default_factory=dict)
    expected_share: Dict[int, float] = field(default_factory=dict)
    max_deviation: float = 0.0

    def summary(self) -> str:
        """crushtool --test --show-utilization-style text."""
        lines = [f"tested {self.n_inputs} inputs, numrep {self.result_max}: "
                 f"{self.total_placements} placements, "
                 f"{len(self.bad_mappings)} bad mappings"]
        for dev in sorted(self.device_counts):
            exp = self.expected_share.get(dev, 0.0) * self.total_placements
            got = self.device_counts[dev]
            lines.append(
                f"  device {dev}:\t{got}\texpected {exp:.0f}")
        lines.append(f"  max deviation from weight share: "
                     f"{self.max_deviation:.3f}")
        return "\n".join(lines)


class CrushTester:
    def __init__(self, cmap: CrushMap, device=None):
        self.map = cmap
        self.device = device

    def _weights_under(self, root: int) -> Dict[int, int]:
        out: Dict[int, int] = {}

        def walk(bid: int, w: int):
            b = self.map.buckets[bid]
            total = b.weight or 1
            for item, iw in zip(b.items, b.weights):
                share = w * iw // total
                if item >= 0:
                    out[item] = out.get(item, 0) + share
                else:
                    walk(item, share)

        walk(root, 1 << 32)
        return out

    def test(self, ruleno: int, result_max: int,
             min_x: int = 0, max_x: int = 1023,
             weights: Optional[List[int]] = None,
             choose_args=None) -> TestReport:
        m = self.map
        if weights is None:
            weights = [0x10000] * m.max_devices
        xs = range(min_x, max_x + 1)
        # TensorMapper raises NotImplementedError for maps it cannot
        # batch (non-straw2 buckets, local retries, sparse bucket ids)
        try:
            tm = TensorMapper(m, device=self.device)
            out, lens = tm.do_rule_batch(
                ruleno, np.arange(min_x, max_x + 1, dtype=np.uint32),
                result_max=result_max,
                weights=np.asarray(weights, dtype=np.uint32),
                choose_args=choose_args)
        except NotImplementedError as e:
            KERNELS.inc("crush_scalar_fallbacks")
            logging.getLogger("ceph_tpu_torch.crush").warning(
                "crushtool test of rule %d runs on the scalar mapper (%s)",
                ruleno, e)
            sm = ScalarMapper(m)
            results = [sm.do_rule(ruleno, x, result_max, weights,
                                  choose_args=choose_args) for x in xs]
        else:
            out = out.cpu().numpy()
            lens = lens.cpu().numpy()
            results = [[int(v) for v in out[i, :int(lens[i])]]
                       for i in range(out.shape[0])]

        report = TestReport(n_inputs=len(results), result_max=result_max,
                            total_placements=0)
        for x, res in zip(xs, results):
            live = [d for d in res if d != CRUSH_ITEM_NONE]
            if len(live) < result_max:
                report.bad_mappings.append(x)
            for j, d in enumerate(live):
                report.device_counts[d] = report.device_counts.get(d, 0) + 1
                if j == 0:
                    report.first_counts[d] = \
                        report.first_counts.get(d, 0) + 1
            report.total_placements += len(live)

        # expected share from the rule's TAKE root subtree weights,
        # modulated by the reweight vector (crushtool --show-utilization)
        take = next((s[1] for s in m.rules[ruleno].steps if s[0] == 1), None)
        if take is not None and take in m.buckets:
            shares = self._weights_under(take)
            for d in list(shares):
                if d < len(weights):
                    shares[d] = shares[d] * weights[d] // 0x10000
            total = sum(shares.values()) or 1
            report.expected_share = {d: s / total
                                     for d, s in shares.items()}
            if report.total_placements:
                for d, exp in report.expected_share.items():
                    got = report.device_counts.get(d, 0) / \
                        report.total_placements
                    report.max_deviation = max(
                        report.max_deviation, abs(got - exp))
        return report
