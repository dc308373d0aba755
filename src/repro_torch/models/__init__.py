"""Model zoo: the paper's SNN classifier (:mod:`.snn`, :mod:`.graph`) and
the 10 assigned language-model architectures (:mod:`.config`,
:mod:`.layers`, :mod:`.lm`, :mod:`.whisper`)."""
