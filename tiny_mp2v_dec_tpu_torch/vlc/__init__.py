"""ISO/IEC 13818-2 Annex B VLC tables (:mod:`.tables`) and the flat
decode LUTs built from them (:mod:`.lut`)."""
