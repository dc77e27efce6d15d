"""The Hadoop Fair Scheduler ("FAIR", Sect. 2.2), single pool, with delay
scheduling [31].

"When a slot on a machine is free and needs to be assigned a task, FAIR
proceeds as follows: if there is any job below its minimum share, it
schedules a task of that particular job.  Otherwise, FAIR schedules a task
that belongs to the job that has received less resource, based on the
notion of 'deficit'."

With a single pool and default parameters the minimum share is 0, so the
deficit rule drives everything: free slots go to the job whose running-task
count is furthest below its max-min fair share.  No preemption.

Per pass, each job is granted up to its (max-min) fair target in deficit
order — equivalent to the slot-at-a-time deficit rule but one sort per
pass instead of one per slot.

Iteration goes through the base scheduler's demand indexes
(:meth:`~repro_torch.core.scheduler.Scheduler.demand_union`): the fair targets
are computed over every phase-live job (running counts shape the
deficits), but the assignment sort covers only jobs with pending demand —
the only ones that can receive a slot — so the per-pass sort is
O(pending jobs x log) instead of O(live jobs x log).
"""

from __future__ import annotations

from repro_torch.core.disciplines import FairDeficitRank
from repro_torch.core.scheduler import Action, ClusterView, Scheduler
from repro_torch.core.types import Phase
from repro_torch.core.vcluster import discrete_allocation


class FairScheduler(Scheduler):
    name = "fair"
    #: The discipline rank this scheduler assembles (registry entry
    #: "fair"): the per-pass deficit sort uses exactly this key.
    rank_policy = FairDeficitRank

    def schedule(self, view: ClusterView, now: float) -> list[Action]:
        self._begin_pass()
        actions: list[Action] = []
        for phase in (Phase.MAP, Phase.REDUCE):
            if self.config.paranoid_indexes:
                self._paranoid_check(view, phase)
            free = view.free_slots(phase)
            if not free:
                continue
            if self.config.demand_indexed:
                by_id = self.demand_union(phase)
            else:
                # Index-free reference: scan the live table directly.
                by_id = self.live_jobs_scan(phase)
            if not by_id:
                continue
            demands = {
                jid: (self._demand(js, phase), js.spec.weight)
                for jid, js in by_id.items()
            }
            # Equal-share max-min targets over *total* slots.
            targets = discrete_allocation(
                demands,
                self.cluster.slots(phase),
                {jid: 0 for jid in by_id},  # no small-first bias
            )
            # Deficit order: furthest below fair target first, FIFO ties.
            # Only jobs with pending tasks can take a slot; the demand
            # index narrows the sort to exactly those (a job without
            # pending demand is a no-op in _assign_pending regardless of
            # its deficit).
            if self.config.demand_indexed:
                # The pending index is a subset of demand_union by the
                # paranoid-checked invariant — no membership re-filter.
                cand = list(self._jobs_pending[phase.value])
            else:
                cand = list(by_id)
            order = sorted(
                cand, key=FairDeficitRank.deficit_key(targets, by_id, phase)
            )
            for j in order:
                if not free:
                    break
                js = by_id[j]
                deficit = targets[j] - js.n_running(phase)
                if deficit <= 0:
                    continue
                acts, free = self._assign_pending(js, phase, free, deficit, now)
                actions.extend(acts)
        return actions
