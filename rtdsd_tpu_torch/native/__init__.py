"""Host-side native code of the port: the FLAC / WAV decoder and batch
loader (:mod:`.flac`), built with the host compiler at first use."""
