"""The multi-device side: the banking bridge to partition specs and
DTensor placements (``sharding``), activation hints (``hints``), the int8
error-feedback gradient mean and gloo's host staging (``collectives``),
and the GPipe pipeline (``pipeline``).  Nothing here starts a process
group: the caller does, and hands its groups in."""
