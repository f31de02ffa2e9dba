"""The port's copy of `bisinger_tpu/utils/text_encoder.py`, unchanged.

Phone/token vocabulary encoder.

Behaviour-compatible with the reference `TokenTextEncoder`
(`train_bisinger/utils/text_encoder.py:158-305`):

  - reserved ids ``<pad>``=0, ``<EOS>``=1, ``<UNK>``=2 prepended when the
    vocab comes from a list (not when read from a file, which is assumed to
    already contain them);
  - optional OOV replacement token;
  - ``sil_phonemes()`` = every token containing no ASCII letter (the
    reference's punctuation/silence convention).

Host-side, pure Python — token ids are produced offline by the binarizer and
inference frontend, never on device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

PAD = "<pad>"
EOS = "<EOS>"
UNK = "<UNK>"
SEG = "|"
RESERVED_TOKENS = [PAD, EOS, UNK]
PAD_ID = 0
EOS_ID = 1
UNK_ID = 2


class TokenTextEncoder:
    def __init__(
        self,
        vocab_list: Optional[Sequence[str]] = None,
        vocab_filename: Optional[str] = None,
        replace_oov: Optional[str] = None,
        prepend_reserved: bool = True,
    ):
        if vocab_filename is not None:
            with open(vocab_filename) as f:
                tokens = [line.strip() for line in f if line.strip()]
            # a file is assumed to already include reserved tokens
            self._id_to_token = dict(enumerate(tokens))
        else:
            assert vocab_list is not None
            tokens = list(vocab_list)
            if prepend_reserved:
                tokens = RESERVED_TOKENS + tokens
            self._id_to_token = dict(enumerate(tokens))
        self._token_to_id: Dict[str, int] = {
            t: i for i, t in self._id_to_token.items()
        }
        self._replace_oov = replace_oov
        self.pad_index = self._token_to_id.get(PAD, PAD_ID)
        self.eos_index = self._token_to_id.get(EOS, EOS_ID)
        self.unk_index = self._token_to_id.get(UNK, UNK_ID)
        self.seg_index = self._token_to_id.get(SEG, self.eos_index)

    # -- encode / decode ----------------------------------------------------
    def encode(self, s: str) -> List[int]:
        tokens = s.strip().split()
        if self._replace_oov is not None:
            tokens = [
                t if t in self._token_to_id else self._replace_oov for t in tokens
            ]
        # unknown tokens (incl. a replace_oov symbol absent from the vocab)
        # fall back to <UNK>
        return [self._token_to_id.get(t, self.unk_index) for t in tokens]

    def decode(self, ids: Sequence[int], strip_eos: bool = False, strip_padding: bool = False) -> str:
        ids = list(ids)
        if strip_padding and self.pad_index in ids:
            ids = ids[: ids.index(self.pad_index)]
        if strip_eos and self.eos_index in ids:
            ids = ids[: ids.index(self.eos_index)]
        return " ".join(self._id_to_token.get(i, f"ID_{i}") for i in ids)

    def decode_list(self, ids: Sequence[int]) -> List[str]:
        return [self._id_to_token.get(i, f"ID_{i}") for i in ids]

    # -- introspection ------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self._id_to_token)

    def __len__(self) -> int:
        return self.vocab_size

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    def seg(self) -> int:
        return self.seg_index

    def sil_phonemes(self) -> List[str]:
        """Tokens whose FIRST character is not a letter — silence/
        punctuation phones (reference `text_encoder.py:304-305` tests
        `p[0].isalpha()`: a stress-marked 'AH0' or a hanzi token must NOT
        classify as silence, which a whole-token ascii test would do)."""
        return [t for t in self._token_to_id if t and not t[0].isalpha()]

    # -- persistence --------------------------------------------------------
    def store_to_file(self, filename: str):
        with open(filename, "w") as f:
            for i in range(len(self._id_to_token)):
                f.write(self._id_to_token[i] + "\n")


def build_phone_encoder(data_dir: str) -> TokenTextEncoder:
    """Load `phone_set.json` from a binarized data dir (reference
    `tasks/tts/tts.py:27-33`)."""
    phone_list_file = os.path.join(data_dir, "phone_set.json")
    with open(phone_list_file) as f:
        phone_list = json.load(f)
    return TokenTextEncoder(vocab_list=phone_list, replace_oov=",")
