"""Operations and bytes the served frames need, counted from the
reference's spikes and the masks (never from the program's counters), per
kernel form (``<kernel>.py``) and for the whole step (``step.py``)."""
