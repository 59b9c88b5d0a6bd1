"""Program analysis of the port (the part of ``paddle_tpu/analysis`` the
sharding planner needs): the census of one step's dispatched ops and
collectives (:mod:`collectives`). The HLO tools stay with ROADMAP.md A.6.
"""
