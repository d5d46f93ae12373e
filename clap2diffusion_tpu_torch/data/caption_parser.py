"""AudioCaps caption -> hierarchy labels (a copy of
``clap2diffusion_tpu/data/caption_parser.py``, numpy- and regex-only): the
reference parser's keyword split rules, sound-category lexicon,
relationship classifier and complexity estimate, with verbs found by a
lexicon and morphology instead of NLTK's tagger. A fix to the JAX original
must be copied here (ROADMAP known delta 3).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

TEMPORAL_KEYWORDS = ["while", "as", "during", "when"]
ADDITIVE_KEYWORDS = ["and", "with", "along with", "as well as"]
ENVIRONMENTAL_KEYWORDS = ["in", "at", "inside", "outside", "near", "by"]
BACKGROUND_KEYWORDS = [
    "in the background", "in the distance", "faintly", "softly",
]

SOUND_CATEGORIES = {
    "human": ["talk", "speak", "voice", "laugh", "cry", "shout", "sing", "whisper"],
    "animal": ["bark", "meow", "chirp", "roar", "howl", "moo", "neigh"],
    "vehicle": ["car", "truck", "bus", "motorcycle", "engine", "horn", "brake"],
    "nature": ["wind", "rain", "thunder", "water", "wave", "storm", "leaves"],
    "music": ["music", "instrument", "piano", "guitar", "drum", "violin"],
    "mechanical": ["machine", "motor", "fan", "drill", "saw", "pump"],
    "impact": ["bang", "crash", "hit", "knock", "slam", "break", "shatter"],
}

# Small sound-verb lexicon for NLTK-free action extraction.
_VERB_STEMS = {
    "talk", "speak", "laugh", "cry", "shout", "sing", "whisper", "bark",
    "meow", "chirp", "roar", "howl", "moo", "neigh", "play", "pass", "fall",
    "blow", "rumble", "open", "close", "knock", "bang", "crash", "hit",
    "slam", "break", "shatter", "run", "drive", "honk", "ring", "buzz",
    "hum", "drip", "splash", "whistle", "clap", "stomp", "squeak", "rattle",
    "give", "make", "sound", "echo", "rain", "thunder", "crow", "quack",
}
_STOPWORDS = {
    "a", "an", "the", "is", "are", "was", "were", "in", "at", "on", "of",
    "and", "with", "while", "as", "during", "when", "by", "near", "to",
}


def _clean_text(text: str) -> str:
    text = " ".join(text.split())
    text = text.strip(".,;:")
    for article in ("a ", "an ", "the "):
        if text.startswith(article):
            text = text[len(article):]
    return text.strip()


class AudioCaptionParser:
    """Drop-in equivalent of the reference parser (same output schema)."""

    def parse_caption(self, caption: str) -> Dict:
        caption = caption.lower().strip()
        primary, secondary, context = self._extract_hierarchy(caption)
        return {
            "original": caption,
            "primary": primary,
            "secondary": secondary,
            "context": context,
            "categories": self._identify_categories(caption),
            "relationships": self._analyze_relationships(caption),
            "actions": self._extract_actions(caption),
            "complexity": self._estimate_complexity(caption),
        }

    def _extract_hierarchy(self, caption: str) -> Tuple[List[str], List[str], List[str]]:
        primary: List[str] = []
        secondary: List[str] = []
        context: List[str] = []

        if any(k in caption for k in BACKGROUND_KEYWORDS):
            for keyword in BACKGROUND_KEYWORDS:
                if keyword in caption:
                    parts = caption.split(keyword)
                    if len(parts) > 1:
                        primary.append(parts[0].strip())
                        secondary.append(parts[1].strip())

        for keyword in TEMPORAL_KEYWORDS:
            if keyword in caption:
                parts = caption.split(keyword)
                if len(parts) > 1:
                    primary.append(parts[0].strip())
                    secondary.append(parts[1].strip())

        for keyword in ENVIRONMENTAL_KEYWORDS:
            if f" {keyword} " in caption:
                pattern = rf"{keyword}\s+([a-z\s]+?)(?:,|\.|$|and|while)"
                context.extend(re.findall(pattern, caption))

        if not primary and not secondary:
            if " and " in caption:
                events = caption.split(" and ")
                primary = [events[0]] if events else []
                secondary = events[1:] if len(events) > 1 else []
            else:
                primary = [caption]

        primary = [_clean_text(p) for p in primary if p]
        secondary = [_clean_text(s) for s in secondary if s]
        context = [_clean_text(c) for c in context if c]
        return primary, secondary, context

    def _identify_categories(self, caption: str) -> List[str]:
        return [
            cat for cat, kws in SOUND_CATEGORIES.items()
            if any(k in caption for k in kws)
        ]

    def _analyze_relationships(self, caption: str) -> str:
        if any(k in caption for k in TEMPORAL_KEYWORDS):
            return "simultaneous"
        if any(k in caption for k in ADDITIVE_KEYWORDS):
            return "additive"
        if any(k in caption for k in ENVIRONMENTAL_KEYWORDS):
            return "spatial"
        return "single"

    def _extract_actions(self, caption: str) -> List[str]:
        """Lexicon + morphology verb heuristic (NLTK-free)."""
        words = re.findall(r"[a-z]+", caption)
        verbs = []
        for w in words:
            if w in _STOPWORDS:
                continue
            stems = {w}
            if w.endswith("ing"):
                stems |= {w[:-3], w[:-3] + "e"}
                if len(w) > 4 and w[-4] == w[-5]:
                    stems.add(w[:-4])
            elif w.endswith("es"):
                stems |= {w[:-2], w[:-1]}
            elif w.endswith("s"):
                stems.add(w[:-1])
            elif w.endswith("ed"):
                stems |= {w[:-2], w[:-1]}
            if stems & _VERB_STEMS:
                verbs.append(w)
        return verbs

    def _estimate_complexity(self, caption: str) -> str:
        event_count = len(caption.split(" and ")) + len(caption.split(" while "))
        if event_count >= 3:
            return "complex"
        if event_count == 2:
            return "moderate"
        return "simple"

    def get_hierarchy_labels(self, parsed: Dict) -> Dict[str, str]:
        labels = {
            "foreground": " ".join(parsed["primary"][:1]),
            "background": " ".join(parsed["secondary"][:1]) if parsed["secondary"] else "",
            "ambience": " ".join(parsed["context"]) if parsed["context"] else "",
        }
        if not labels["background"] and parsed["categories"]:
            labels["background"] = f"{parsed['categories'][0]} sounds"
        if not labels["ambience"]:
            if parsed["complexity"] == "complex":
                labels["ambience"] = "busy environment"
            elif parsed["complexity"] == "simple":
                labels["ambience"] = "quiet setting"
            else:
                labels["ambience"] = "ambient sounds"
        return labels
