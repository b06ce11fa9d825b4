// Microphone-driven recognition service.  Role parity with the reference
// org.vosk.android.SpeechService (/root/reference/android/lib/src/main/
// java/org/vosk/android/SpeechService.java:32-257): owns an AudioRecord
// on the VOICE_RECOGNITION source, pumps 0.2 s buffers through a
// Recognizer on a worker thread, and posts partial/final/error callbacks
// to the main looper.  Original implementation for the vosk_tpu runtime
// (structure: a single pump loop with a state latch instead of the
// reference's timeout-handler chain; pause/mute are plain volatile flags).
//
// NOTE ON DEPLOYMENT: the vosk_tpu engine targets accelerator-backed servers; the
// expected mobile topology is this service streaming to a vosk_tpu
// websocket server (server/ws.py) rather than linking the engine
// on-device.  The on-device path compiles against the same C ABI
// (libvosk_tpu.so) for API-compatibility testing.
package org.vosk_tpu.android;

import android.annotation.SuppressLint;
import android.media.AudioFormat;
import android.media.AudioRecord;
import android.media.MediaRecorder;
import android.os.Handler;
import android.os.Looper;

import org.vosk_tpu.VoskTpu;

import java.io.IOException;

public class SpeechService {

    private final VoskTpu.Recognizer recognizer;
    private final int sampleRate;
    private final int bufferSize;
    private final AudioRecord recorder;

    private Thread recognizerThread;
    private final Handler mainHandler = new Handler(Looper.getMainLooper());

    private volatile boolean paused;
    private volatile boolean running;

    @SuppressLint("MissingPermission")
    public SpeechService(VoskTpu.Recognizer recognizer, float sampleRate)
            throws IOException {
        this.recognizer = recognizer;
        this.sampleRate = (int) sampleRate;
        // 0.2 s of mono 16-bit samples, like the engine's internal chunk
        this.bufferSize = Math.round(this.sampleRate * 0.2f * 2);
        this.recorder = new AudioRecord(
                MediaRecorder.AudioSource.VOICE_RECOGNITION,
                this.sampleRate,
                AudioFormat.CHANNEL_IN_MONO,
                AudioFormat.ENCODING_PCM_16BIT,
                bufferSize * 2);
        if (recorder.getState() == AudioRecord.STATE_UNINITIALIZED) {
            recorder.release();
            throw new IOException(
                    "Failed to initialize recorder. Microphone might be already in use.");
        }
    }

    /** Start pumping microphone audio into the recognizer. */
    public boolean startListening(RecognitionListener listener) {
        if (running) return false;
        running = true;
        paused = false;
        recognizerThread = new Thread(() -> pump(listener, -1),
                "VoskTpuSpeechService");
        recognizerThread.start();
        return true;
    }

    /** Start with a timeout (ms); fires onTimeout when it elapses. */
    public boolean startListening(RecognitionListener listener, int timeoutMs) {
        if (running) return false;
        running = true;
        paused = false;
        recognizerThread = new Thread(() -> pump(listener, timeoutMs),
                "VoskTpuSpeechService");
        recognizerThread.start();
        return true;
    }

    /** Stop listening; delivers onFinalResult first. */
    public boolean stop() {
        if (!running) return false;
        running = false;
        try {
            recognizerThread.join();
        } catch (InterruptedException e) {
            Thread.currentThread().interrupt();
        }
        recognizerThread = null;
        return true;
    }

    /** Stop WITHOUT delivering a final result. */
    public boolean cancel() {
        if (!running) return false;
        paused = true; // suppress callbacks
        return stop();
    }

    /** Pause/resume callback delivery while keeping the mic open. */
    public void setPause(boolean pause) {
        this.paused = pause;
    }

    /** Reset the recognizer mid-stream (drops the current utterance). */
    public void reset() {
        recognizer.reset();
    }

    /** Release the microphone; the service cannot be restarted after. */
    public void shutdown() {
        stop();
        recorder.release();
    }

    private void pump(RecognitionListener listener, int timeoutMs) {
        recorder.startRecording();
        if (recorder.getRecordingState() == AudioRecord.RECORDSTATE_STOPPED) {
            running = false;
            recorder.stop();
            post(() -> listener.onError(
                    new IOException("Failed to start recording. Microphone in use?")));
            return;
        }
        byte[] buffer = new byte[bufferSize];
        long deadline = timeoutMs > 0 ? System.currentTimeMillis() + timeoutMs : Long.MAX_VALUE;
        try {
            while (running) {
                if (System.currentTimeMillis() > deadline) {
                    post(listener::onTimeout);
                    break;
                }
                int n = recorder.read(buffer, 0, buffer.length);
                if (n < 0) throw new IOException("AudioRecord.read returned " + n);
                if (paused) continue;
                if (recognizer.acceptWaveform(buffer, n)) {
                    final String r = recognizer.getResult();
                    post(() -> listener.onResult(r));
                } else {
                    final String p = recognizer.getPartialResult();
                    post(() -> listener.onPartialResult(p));
                }
            }
            if (!paused) {
                final String f = recognizer.getFinalResult();
                post(() -> listener.onFinalResult(f));
            }
        } catch (Exception e) {
            post(() -> listener.onError(e));
        } finally {
            recorder.stop();
            running = false;
        }
    }

    private void post(Runnable r) {
        mainHandler.post(r);
    }
}
